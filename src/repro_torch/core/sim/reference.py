"""``reference`` backend — the host list scheduler, one placement at a time.

Port of ``repro/core/sim/reference.py``.  The ground truth every device
backend is held against, and the path host reward callables (a measured
executor) take conceptually: it scores on the host with ``simulate`` in
float64, whatever device the backend was built for.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..costmodel import BatchSimResult, SimResult, sim_arrays, simulate
from .base import SimulatorBackend, register_backend

__all__ = ["ReferenceBackend", "RefSim"]


class RefSim(NamedTuple):
    """Prepared handle: the graph/platform pair plus the retire order."""

    graph: object            # CompGraph
    platform: object         # Platform
    order: np.ndarray        # (V,) retire order handed to ``simulate``


class ReferenceBackend(SimulatorBackend):
    name = "reference"

    def __init__(self, device=None):
        # The host oracle: ``device`` (what ``get_backend`` passes) is
        # accepted and not used for scoring.
        del device

    def prepare(self, graph, platform, *,
                order: Optional[np.ndarray] = None,
                schedule: str = "topo") -> RefSim:
        """``order`` (or ``schedule=``) picks the retire order — pass the
        level backend's order to cross-check it against the ground truth."""
        if order is None:
            order = sim_arrays(graph, platform, schedule=schedule).order
        return RefSim(graph, platform, np.asarray(order, np.int64))

    def simulate(self, prep: RefSim, placement) -> SimResult:
        return simulate(prep.graph, np.asarray(placement, np.int64),
                        prep.platform, order=prep.order)

    def simulate_batch(self, prep: RefSim, placements) -> BatchSimResult:
        host = torch.as_tensor(placements).cpu().numpy()
        results = [self.simulate(prep, p) for p in host]
        return BatchSimResult(
            latency=np.asarray([r.latency for r in results]),
            reward=np.asarray([r.reward for r in results]),
            oom=np.asarray([r.oom for r in results]),
            per_device_busy=np.stack([r.per_device_busy for r in results])
            if results else np.zeros((0, prep.platform.num_devices)),
            transfer_time=np.asarray([r.transfer_time for r in results]),
        )

    def schedule_order(self, prep: RefSim) -> np.ndarray:
        return prep.order


register_backend(ReferenceBackend)
