"""Simulation layer: backend registry, the level, scan and reference
backends, reward pipeline and the window rollout engine."""
from .base import (SimulatorBackend, backend_names, get_backend,
                   register_backend, single_from_batch, stack_batch_results)
from .level import LevelBackend, LevelSim
from .pipeline import RewardPipeline
from .reference import RefSim, ReferenceBackend
from .rollout import (ChainStreams, MultiRolloutEngine, RolloutEngine,
                      WindowNoise, WindowRecord)
from .scan import ScanBackend, ScanSim

__all__ = ["SimulatorBackend", "backend_names", "get_backend",
           "register_backend", "single_from_batch", "stack_batch_results",
           "LevelBackend",
           "LevelSim", "ScanBackend", "ScanSim",
           "ReferenceBackend", "RefSim", "RewardPipeline", "ChainStreams",
           "MultiRolloutEngine", "RolloutEngine", "WindowNoise", "WindowRecord"]
