"""Simulation layer: backend registry, the level, scan and reference
backends, reward pipeline and the window rollout engine."""
from .base import (SimulatorBackend, backend_names, get_backend,
                   register_backend, single_from_batch)
from .level import LevelBackend, LevelSim
from .pipeline import RewardPipeline
from .reference import RefSim, ReferenceBackend
from .rollout import ChainStreams, RolloutEngine, WindowNoise, WindowRecord
from .scan import ScanBackend, ScanSim

__all__ = ["SimulatorBackend", "backend_names", "get_backend",
           "register_backend", "single_from_batch", "LevelBackend",
           "LevelSim", "ScanBackend", "ScanSim",
           "ReferenceBackend", "RefSim", "RewardPipeline", "ChainStreams",
           "RolloutEngine", "WindowNoise", "WindowRecord"]
