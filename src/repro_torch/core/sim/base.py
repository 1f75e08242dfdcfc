"""Simulator-backend protocol and registry.

Port of ``repro/core/sim/base.py``.  A :class:`SimulatorBackend` turns a
(graph, platform) pair into a prepared, placement-independent handle
(``prepare``, or ``prepare_batch`` for several graphs) and scores placements
against it (``simulate`` / ``simulate_batch`` / ``simulate_multi`` — single,
(B, V) batch, (G, B, V_max) multi-graph).  Backends register under a name;
``get_backend(name, device=...)`` builds one on a device, so each backend's
prepared tensors live where its scorer runs.

A multi-graph handle is the list of the graphs' own handles: each graph is
scored on its own unpadded tables (one ``level_makespan`` launch a graph for
the ``scan`` and ``level`` backends) and the columns of a placement row
beyond the graph's V_g are ignored, as the reference's padding contract
makes them (pad slots are inert data ops).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Type

import numpy as np

__all__ = ["SimulatorBackend", "register_backend", "get_backend",
           "backend_names", "single_from_batch", "stack_batch_results"]


def stack_batch_results(results: Sequence):
    """Stack per-graph ``BatchSimResult`` rows onto a leading (G,) axis."""
    from ..costmodel import BatchSimResult
    return BatchSimResult(
        latency=np.stack([r.latency for r in results]),
        reward=np.stack([r.reward for r in results]),
        oom=np.stack([r.oom for r in results]),
        per_device_busy=np.stack([r.per_device_busy for r in results]),
        transfer_time=np.stack([r.transfer_time for r in results]),
    )


def single_from_batch(batch, i: int = 0):
    """Row ``i`` of a ``BatchSimResult`` as a host ``SimResult``."""
    from ..costmodel import SimResult
    return SimResult(float(batch.latency[i]), batch.per_device_busy[i],
                     float(batch.transfer_time[i]), bool(batch.oom[i]))


class SimulatorBackend:
    """Interface every simulation engine implements."""

    name: str = "?"
    #: the reference scores this backend inside its jitted rollout
    #: (``jit_fused``), where the device head's capacity mask rides along
    fused: bool = False

    def prepare(self, graph, platform):
        """Placement-independent handle for one (graph, platform) pair."""
        raise NotImplementedError

    def prepare_host(self, graph, platform):
        """The host half of ``prepare`` (numpy only, so a worker thread may
        build it); ``None`` for a backend with no host tables."""
        return None

    def prepare_device(self, graph, platform, host):
        """A handle from :meth:`prepare_host`'s result, on the backend's
        device, uncached."""
        return self.prepare(graph, platform)

    def simulate(self, prep, placement):
        """One placement → host ``SimResult``."""
        raise NotImplementedError

    def simulate_batch(self, prep, placements):
        """(B, V) placements → host ``BatchSimResult``."""
        raise NotImplementedError

    def prepare_batch(self, graphs: Sequence, platform, *,
                      v_max: Optional[int] = None) -> List:
        """Handles of several graphs, the list of ``prepare``'s.

        ``v_max`` is the reference's pin of the padded node axis: it is
        checked against the largest graph (a smaller pin raises), and
        otherwise changes nothing here, where each graph is scored unpadded.
        """
        if not graphs:
            raise ValueError("prepare_batch needs at least one graph")
        need = max(g.num_nodes for g in graphs)
        if v_max is not None and v_max < need:
            raise ValueError(f"v_max={v_max} < largest graph ({need})")
        return [self.prepare(g, platform) for g in graphs]

    def simulate_multi(self, preps: List, placements):
        """(G, B, V_max) placements (tensor or array) → host
        ``BatchSimResult`` with (G, B) axes; row g is scored on its graph's
        first V_g columns, whatever the pad columns hold."""
        if placements.ndim != 3 or placements.shape[0] != len(preps):
            raise ValueError(f"expected (G={len(preps)}, B, V_max) "
                             f"placements; got {tuple(placements.shape)}")
        return stack_batch_results([
            self.simulate_batch(prep,
                                placements[i, :, :prep.graph.num_nodes])
            for i, prep in enumerate(preps)])

    def schedule_order(self, prep):
        """The list-schedule retire order this backend simulates.

        Device queues make the schedule order-sensitive, so the order is part
        of each backend's cost model; parity across backends is defined on a
        common order.
        """
        raise NotImplementedError


_REGISTRY: Dict[str, Type[SimulatorBackend]] = {}


def register_backend(cls: Type[SimulatorBackend]) -> Type[SimulatorBackend]:
    """Register a backend class under ``cls.name`` (latest wins)."""
    _REGISTRY[cls.name] = cls
    return cls


def get_backend(name: str, device="cuda") -> SimulatorBackend:
    """A new backend ``name`` whose scorer runs on ``device``."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown simulator backend {name!r}; registered backends: "
            f"{backend_names()}")
    return _REGISTRY[name](device=device)


def backend_names() -> List[str]:
    return sorted(_REGISTRY)
