"""Topology-aware heterogeneous platform subsystem.

Fleet descriptions (:class:`Topology`, tiered links, device coordinates),
non-uniform platform builders (``nvlink_island`` / ``multi_host`` /
``torus`` / ``ring``), the device feature table that conditions the
``head="device"`` policy, and the exact series-parallel DP baselines.
Port of ``repro/platforms`` (numpy, no JAX).
"""
from .topology import (DEV_FEATURE_DIM, LinkTier, Topology,
                       device_feature_table, multi_host, nvlink_island,
                       ring, torus)
from .exact import DPResult, dp_optimal, hybrid_refine, sp_decompose

__all__ = [
    "LinkTier", "Topology", "nvlink_island", "multi_host", "torus", "ring",
    "device_feature_table", "DEV_FEATURE_DIM",
    "DPResult", "sp_decompose", "dp_optimal", "hybrid_refine",
]
