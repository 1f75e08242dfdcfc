"""``scan`` backend — the node-scan list schedule (``simulate_jax``).

Port of ``repro/core/sim/scan.py``.  The reference retires one node per
``lax.scan`` step in the heap-Kahn topo order, reproducing the host
scheduler's decisions (≤1e-5 relative: f32 vs f64 rounding only).  That walk
is the level kernel on tables of one node a row (``build_chain_arrays``):
each row's predecessors have retired before its readiness is taken, so the
kernel's readiness, first-minimum queue choice and transfer sum are
``simulate_jax``'s step, and data nodes drop out as no-ops in both.  The
backend therefore scores a whole rollout window in one ``level_makespan``
launch on the chain tables; it has no kernel of its own.

This is the default reward of ``engine="auto"`` and ``"batched"``.
"""
from __future__ import annotations

from ...kernels.levelsim import build_chain_arrays
from .base import register_backend
from .level import LevelSim, TableBackend

__all__ = ["ScanBackend", "ScanSim"]


class ScanSim(LevelSim):
    """Prepared handle: the dense view in the chosen schedule's order, its
    chain tables (one non-data node a row) and the fields the scorer reads,
    on the backend's device."""

    __slots__ = ()


class ScanBackend(TableBackend):
    name = "scan"
    fused = True
    _schedule = "topo"
    _build = staticmethod(build_chain_arrays)
    _handle = ScanSim

    def prepare(self, graph, platform, *, schedule: str = "topo") -> ScanSim:
        """``schedule`` picks the retire order: ``"topo"`` (heap-Kahn, the
        host scheduler's default order) or ``"level"`` (then the latencies
        are the ``level`` backend's)."""
        return self._prepare(graph, platform, schedule)


register_backend(ScanBackend)
