"""``level`` backend — the level-parallel makespan kernel.

Port of ``repro/core/sim/level.py``.  The kernel batches over placements
internally, so the backend scores a whole rollout window — every placement
the T steps of B chains produced — in one launch.

Order contract: simulates the **level-major** list schedule (see
``kernels/levelsim.py``) — a valid topological order, but a different cost
model than the node-scan order once device queues contend.  Parity is
asserted against the reference scheduler *on the same order*
(``simulate(..., order=prep.arrays.order)``).
"""
from __future__ import annotations

import weakref
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..._device import resolve_device
from ...kernels.levelsim import (LevelTensors, build_level_arrays,
                                 level_makespan, level_tensors)
from ..costmodel import (BatchSimResult, SimArrays, SimResult, _cache_key,
                         sim_arrays)
from .base import SimulatorBackend, register_backend, single_from_batch

__all__ = ["LevelBackend", "LevelSim"]


class LevelSim(NamedTuple):
    """Prepared handle: the level-schedule dense view, plus its level tables
    and the fields the scorer reads, on the backend's device."""

    graph: object                     # CompGraph
    platform: object                  # Platform
    arrays: SimArrays                 # built with schedule="level"
    tables: LevelTensors              # level-major tables over non-data nodes
    sim: Dict[str, torch.Tensor]      # the SimArrays fields the scorer reads


def _simulate_level(prep: LevelSim, placements: torch.Tensor):
    """(B, V) int32 device ids → (latency, reward, oom, busy, transfer)
    tensors on the placements' device."""
    sim = prep.sim
    B, n = placements.shape
    idx = placements.long()
    ndev = sim["op_time"].shape[0]
    dev_bytes = torch.zeros(B, ndev, device=placements.device).scatter_add_(
        1, idx, sim["bytes_out"][:n].expand(B, n))
    oom = torch.any(dev_bytes > sim["mem_capacity"][None], dim=1)
    dur_all = torch.gather(sim["op_time"].T.expand(B, n, ndev), 2,
                           idx[:, :, None])[..., 0]                  # (B, V)
    busy = torch.zeros(B, ndev, device=placements.device).scatter_add_(
        1, idx, dur_all)
    finish, transfer = level_makespan(prep.tables, placements,
                                      sim["queue_init"], sim["inv_bw"],
                                      sim["lat"])
    latency = finish.amax(dim=1)              # data/pad slots hold 0
    bad = oom | ~torch.isfinite(latency)
    reward = torch.where(bad, torch.zeros_like(latency),
                         1.0 / torch.where(bad, torch.ones_like(latency),
                                           latency))
    return latency, reward, oom, busy, transfer


class LevelBackend(SimulatorBackend):
    name = "level"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        # graph → {costmodel cache key: LevelSim}
        self._cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def prepare(self, graph, platform) -> LevelSim:
        per_graph = self._cache.setdefault(graph, {})
        key = _cache_key(graph, platform)
        prep = per_graph.get(key)
        if prep is None:
            sa = sim_arrays(graph, platform, schedule="level")
            tables = level_tensors(build_level_arrays(sa), self.device)
            sim = {f: torch.as_tensor(np.ascontiguousarray(getattr(sa, f)),
                                      device=self.device)
                   for f in ("op_time", "bytes_out", "mem_capacity",
                             "queue_init", "inv_bw", "lat")}
            prep = per_graph[key] = LevelSim(graph, platform, sa, tables, sim)
        return prep

    def _score(self, prep: LevelSim, placements) -> BatchSimResult:
        p = torch.as_tensor(placements, device=self.device)
        n = prep.arrays.num_nodes
        ndev = prep.arrays.num_devices
        if p.ndim != 2 or p.shape[1] != n:
            raise ValueError(f"expected (B, {n}) placements; got "
                             f"{tuple(p.shape)}")
        if p.numel():
            # The kernel indexes with these ids: check them up front (a
            # gather on the card would fault, not clip).
            lo, hi = int(p.min()), int(p.max())
            if lo < 0 or hi >= ndev:
                raise ValueError(f"placement device ids must be in [0, "
                                 f"{ndev}); got [{lo}, {hi}]")
        res = _simulate_level(prep, p.to(torch.int32).contiguous())
        latency, reward, oom, busy, transfer = (t.cpu().numpy() for t in res)
        return BatchSimResult(latency=latency, reward=reward, oom=oom,
                              per_device_busy=busy, transfer_time=transfer)

    def simulate(self, prep: LevelSim, placement) -> SimResult:
        p = torch.as_tensor(placement, device=self.device)
        return single_from_batch(self._score(prep, p[None]))

    def simulate_batch(self, prep: LevelSim, placements) -> BatchSimResult:
        return self._score(prep, placements)

    def schedule_order(self, prep: LevelSim) -> np.ndarray:
        return np.asarray(prep.arrays.order, np.int64)


register_backend(LevelBackend)
