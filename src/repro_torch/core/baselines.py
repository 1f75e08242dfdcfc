"""Baseline placement methods (paper §3.3), the non-learned half.

Port of ``repro/core/baselines.py``'s heuristics and exact baselines:

1.  ``cpu_only`` / ``gpu_only`` — whole graph on one device.
2.  ``openvino_auto`` — the OpenVINO-CPU / OpenVINO-GPU rows: the AUTO plugin
    runs the preferred device and pays an arbitration overhead (Table 2 shows
    OpenVINO-X ≈ X-only within 2–15%); modeled as preference placement with a
    fixed arbitration factor.
3.  ``dp_placement`` / ``hybrid_placement`` — the exact series-parallel DP
    of ``repro_torch.platforms.exact`` (provably optimal on contention-free
    SP graphs) and its hybrid mode (DP-refined linear segments around an RL
    core placement).

The learned baselines (Placeto, the RNN placer) are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import CompGraph

__all__ = ["cpu_only", "gpu_only", "openvino_auto",
           "dp_placement", "hybrid_placement"]


def cpu_only(graph: CompGraph) -> np.ndarray:
    return np.zeros(graph.num_nodes, dtype=np.int64)


def gpu_only(graph: CompGraph) -> np.ndarray:
    return np.ones(graph.num_nodes, dtype=np.int64)


def dp_placement(graph: CompGraph, platform) -> Tuple[np.ndarray, float]:
    """Exact series-parallel DP placement → (placement, latency).

    Raises ``ValueError`` for graphs outside the two-terminal SP class —
    use :func:`hybrid_placement` there.  Optimal when no device's queue
    limit binds (see ``repro_torch.platforms.exact``).
    """
    from ..platforms import dp_optimal
    res = dp_optimal(graph, platform)
    if res is None:
        raise ValueError(
            f"graph {graph.name!r} is not two-terminal series-parallel — "
            f"the exact DP does not apply (hybrid_placement refines any "
            f"placement's linear segments instead)")
    return res.placement, res.latency


def hybrid_placement(graph: CompGraph, placement: np.ndarray,
                     platform) -> Tuple[np.ndarray, float]:
    """DP-refine the linear segments of an (RL-produced) placement.

    Never worse than the input placement; → (placement, latency)."""
    from ..platforms import hybrid_refine
    res = hybrid_refine(graph, np.asarray(placement), platform)
    return res.placement, res.latency


def openvino_auto(graph: CompGraph, preference: int,
                  arbitration_factor: float = 1.08
                  ) -> Tuple[np.ndarray, float]:
    """AUTO-plugin-style baseline: preferred device + arbitration overhead.

    Returns (placement, latency multiplier to apply to the measured latency).
    """
    placement = np.full(graph.num_nodes, preference, dtype=np.int64)
    return placement, arbitration_factor
