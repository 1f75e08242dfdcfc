"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Importing this package builds nothing: a kernel is compiled with ``nvcc`` the
first time a wrapper is called on CUDA tensors (see ``_build.py``).
"""
from .flash_attention import (flash_attention, flash_attention_ref,
                              flash_pairs, flash_tile_plan)
from .gcn_spmm import (GCNAggregate, GCNGraph, gcn_aggregate,
                       gcn_aggregate_ref, gcn_graph)
from .levelsim import (LevelArrays, LevelTensors, build_level_arrays,
                       level_makespan, level_makespan_ref, level_tensors)
from .rmsnorm import rmsnorm, rmsnorm_ref
from .ssd_scan import ssd_scan, ssd_scan_ref

__all__ = ["GCNAggregate", "GCNGraph", "gcn_aggregate", "gcn_aggregate_ref",
           "gcn_graph", "LevelArrays", "LevelTensors", "build_level_arrays",
           "level_makespan", "level_makespan_ref", "level_tensors",
           "flash_attention", "flash_attention_ref", "flash_pairs",
           "flash_tile_plan", "rmsnorm",
           "rmsnorm_ref", "ssd_scan", "ssd_scan_ref"]
