"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Importing this package builds nothing: a kernel is compiled with ``nvcc`` the
first time a wrapper is called on CUDA tensors (see ``_build.py``).
"""
from .gcn_spmm import (GCNAggregate, GCNGraph, gcn_aggregate,
                       gcn_aggregate_ref, gcn_graph)
from .levelsim import (LevelArrays, LevelTensors, build_level_arrays,
                       level_makespan, level_makespan_ref, level_tensors)

__all__ = ["GCNAggregate", "GCNGraph", "gcn_aggregate", "gcn_aggregate_ref",
           "gcn_graph", "LevelArrays", "LevelTensors", "build_level_arrays",
           "level_makespan", "level_makespan_ref", "level_tensors"]
