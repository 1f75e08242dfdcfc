"""Simulator-backend protocol and registry.

Port of ``repro/core/sim/base.py`` for single graphs.  A
:class:`SimulatorBackend` turns a (graph, platform) pair into a prepared,
placement-independent handle (``prepare``) and scores placements against it
(``simulate`` / ``simulate_batch``).  Backends register under a
name; ``get_backend(name, device=...)`` builds one on a device, so each
backend's prepared tensors live where its scorer runs.
"""
from __future__ import annotations

from typing import Dict, List, Type

__all__ = ["SimulatorBackend", "register_backend", "get_backend",
           "backend_names", "single_from_batch"]


def single_from_batch(batch, i: int = 0):
    """Row ``i`` of a ``BatchSimResult`` as a host ``SimResult``."""
    from ..costmodel import SimResult
    return SimResult(float(batch.latency[i]), batch.per_device_busy[i],
                     float(batch.transfer_time[i]), bool(batch.oom[i]))


_MULTI = ("multi-graph scoring is not ported yet; ROADMAP.md 'Modules to "
          "port' item 6 (multi-graph and corpus) ports it")


class SimulatorBackend:
    """Interface every simulation engine implements."""

    name: str = "?"
    #: the reference scores this backend inside its jitted rollout
    #: (``jit_fused``), where the device head's capacity mask rides along
    fused: bool = False

    def prepare(self, graph, platform):
        """Placement-independent handle for one (graph, platform) pair."""
        raise NotImplementedError

    def simulate(self, prep, placement):
        """One placement → host ``SimResult``."""
        raise NotImplementedError

    def simulate_batch(self, prep, placements):
        """(B, V) placements → host ``BatchSimResult``."""
        raise NotImplementedError

    def prepare_batch(self, graphs, platform, **kw):
        """Padded multi-graph handle (the reference's ``from_graphs`` path)."""
        raise NotImplementedError(_MULTI)

    def simulate_multi(self, prep, placements):
        """(G, B, V_max) placements of a padded multi-graph batch."""
        raise NotImplementedError(_MULTI)

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
