"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Importing this package builds nothing: a kernel is compiled with ``nvcc`` the
first time a wrapper is called on CUDA tensors (see ``_build.py``).
"""
from .flash_attention import (flash_attention, flash_attention_ref,
                              flash_attention_work, flash_pairs,
                              flash_tile_plan)
from .gcn_spmm import (GCNAggregate, GCNGraph, SageAggregate, gcn_aggregate,
                       gcn_aggregate_ref, gcn_graph, sage_aggregate,
                       sage_aggregate_ref)
from .levelsim import (LevelArrays, LevelTensors, build_chain_arrays,
                       build_level_arrays, level_makespan, level_makespan_ref,
                       level_tensors)
from .rmsnorm import rmsnorm, rmsnorm_launch_plan, rmsnorm_ref, rmsnorm_work
from .ssd_scan import ssd_scan, ssd_scan_ref, ssd_scan_work

__all__ = ["GCNAggregate", "GCNGraph", "gcn_aggregate", "gcn_aggregate_ref",
           "gcn_graph", "SageAggregate", "sage_aggregate",
           "sage_aggregate_ref", "LevelArrays", "LevelTensors", "build_chain_arrays",
           "build_level_arrays",
           "level_makespan", "level_makespan_ref", "level_tensors",
           "flash_attention", "flash_attention_ref", "flash_attention_work",
           "flash_pairs", "flash_tile_plan", "rmsnorm", "rmsnorm_launch_plan",
           "rmsnorm_ref", "rmsnorm_work", "ssd_scan", "ssd_scan_ref",
           "ssd_scan_work"]
