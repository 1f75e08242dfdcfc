"""Simulation layer: backend registry, the level, scan and reference
backends, reward pipeline, the window rollout engine and its sharded
counterpart."""
from .base import (SimulatorBackend, backend_names, get_backend,
                   register_backend, single_from_batch, stack_batch_results)
from .level import LevelBackend, LevelSim
from .pipeline import RewardPipeline
from .reference import RefSim, ReferenceBackend
from .rollout import (ChainStreams, MultiRolloutEngine, RolloutEngine,
                      WindowNoise, WindowRecord)
from .scan import ScanBackend, ScanSim
from .sharded import ShardedRolloutEngine, make_rollout_mesh

__all__ = ["SimulatorBackend", "backend_names", "get_backend",
           "register_backend", "single_from_batch", "stack_batch_results",
           "LevelBackend",
           "LevelSim", "ScanBackend", "ScanSim",
           "ReferenceBackend", "RefSim", "RewardPipeline", "ChainStreams",
           "MultiRolloutEngine", "RolloutEngine", "WindowNoise", "WindowRecord",
           "ShardedRolloutEngine", "make_rollout_mesh"]
