"""Simulation layer: backend registry, the level backend, reward pipeline and
the window rollout engine."""
from .base import (SimulatorBackend, backend_names, get_backend,
                   register_backend, single_from_batch)
from .level import LevelBackend, LevelSim
from .pipeline import RewardPipeline
from .rollout import ChainStreams, RolloutEngine, WindowNoise, WindowRecord

__all__ = ["SimulatorBackend", "backend_names", "get_backend",
           "register_backend", "single_from_batch", "LevelBackend",
           "LevelSim", "RewardPipeline", "ChainStreams", "RolloutEngine",
           "WindowNoise", "WindowRecord"]
