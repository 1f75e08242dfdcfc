"""RewardPipeline — turns a rollout window's placements into rewards.

Port of ``repro/core/sim/pipeline.py``.  Two reward sources: a registered
simulator backend, whose :meth:`score_window` scores the (T, B, V)
placements of one graph's window in one backend call (one kernel launch for
``scan`` and ``level``), or a host callable ``reward_fn`` (a measured
executor's slot), called once per placement in the reference's (t, b)
order.  A pipeline over G graphs (:meth:`RewardPipeline.from_graphs`)
scores a window given as one (T, B, V_g) tensor a graph — each graph on its
own handle, unpadded — into (T, G, B) rewards, and calls a host callable in
the reference's (t, g, b) order.  The single-graph search is the case G=1.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .base import SimulatorBackend, get_backend

__all__ = ["RewardPipeline"]


class RewardPipeline:
    """Scores rollout windows of G ≥ 1 graphs; see module docstring."""

    def __init__(self, *, backend: Optional[SimulatorBackend] = None,
                 preps: Optional[List] = None,
                 reward_fn: Optional[Callable] = None,
                 num_nodes: Optional[Sequence[int]] = None):
        if (backend is None) == (reward_fn is None):
            raise ValueError("pass exactly one of backend= or reward_fn=")
        self.backend = backend
        self.preps = preps                 # the backend's handle of each graph
        self.reward_fn = reward_fn
        # the true node count of each graph (None: the whole row)
        self.num_nodes = (None if num_nodes is None else
                          [int(n) for n in num_nodes])

    @property
    def prep(self):
        """The first (for a single-graph pipeline, the only) graph's
        handle."""
        return self.preps[0]

    @property
    def fused(self) -> bool:
        """Whether the reference scores this reward inside its jitted
        rollout (its ``pipeline.fused``): the ``scan`` backend, not
        ``level``, ``reference`` or a ``reward_fn``.  The device head's
        capacity mask applies only then."""
        return self.backend is not None and self.backend.fused

    @property
    def fit_ok(self):
        """(V, D) bool: node v's bytes alone fit device d
        (``SimArrays.fit_ok``) — the device head's capacity mask."""
        return self.prep.arrays.fit_ok

    @classmethod
    def from_reward_fn(cls, reward_fn: Callable, *,
                       num_nodes: Optional[int] = None) -> "RewardPipeline":
        """Host callable ``fn(fine_placement) -> (reward, latency)``.

        ``num_nodes`` is the graph's true node count: the callable sees only
        the ``:num_nodes`` prefix of each placement row.
        """
        return cls(reward_fn=reward_fn,
                   num_nodes=None if num_nodes is None else [num_nodes])

    @classmethod
    def from_platform(cls, graph, platform, backend: str = "scan", *,
                      device="cuda") -> "RewardPipeline":
        """Single-graph pipeline over a registered simulator backend."""
        b = get_backend(backend, device=device) \
            if isinstance(backend, str) else backend
        return cls(backend=b, preps=[b.prepare(graph, platform)],
                   num_nodes=[graph.num_nodes])

    @classmethod
    def from_graphs(cls, graphs: Sequence, platform, *,
                    backend: str = "scan", device="cuda") -> "RewardPipeline":
        """Pipeline over several graphs and a registered simulator
        backend."""
        b = get_backend(backend, device=device) \
            if isinstance(backend, str) else backend
        return cls(backend=b, preps=b.prepare_batch(graphs, platform),
                   num_nodes=[g.num_nodes for g in graphs])

    def graph(self, g: int) -> "RewardPipeline":
        """Graph ``g`` as a one-graph pipeline (its ``fused`` and ``fit_ok``
        are graph g's)."""
        return RewardPipeline(
            backend=self.backend, reward_fn=self.reward_fn,
            preps=None if self.preps is None else [self.preps[g]],
            num_nodes=None if self.num_nodes is None else [self.num_nodes[g]])

    def score_window(self, fines):
        """(T, B, V) placements (tensor or array) of a one-graph pipeline,
        or a sequence of one (T, B, V_g) window a graph → (rewards,
        latencies), (T, B) or (T, G, B), float64 on the host."""
        if isinstance(fines, (list, tuple)):
            return self._score_multi(fines)
        if fines.ndim != 3:
            raise ValueError(f"expected (T, B, V) placements or one such "
                             f"window a graph; got {tuple(fines.shape)}")
        return self._score_graph(0, fines)

    def _nodes(self, g: int, width: int) -> int:
        return self.num_nodes[g] if self.num_nodes is not None else width

    def _score_graph(self, g: int, fines):
        T, B, V = fines.shape
        nn = self._nodes(g, V)
        if self.reward_fn is not None:
            host = torch.as_tensor(fines).cpu().numpy()
            rewards = np.empty((T, B))
            latencies = np.empty((T, B))
            for t in range(T):            # (t, b) order — scalar-engine order
                for b in range(B):
                    rewards[t, b], latencies[t, b] = self.reward_fn(
                        host[t, b, :nn])
            return rewards, latencies
        res = self.backend.simulate_batch(
            self.preps[g], fines[:, :, :nn].reshape(T * B, nn))
        return (np.asarray(res.reward, np.float64).reshape(T, B),
                np.asarray(res.latency, np.float64).reshape(T, B))

    def _score_multi(self, fines: Sequence):
        if self.reward_fn is None:
            # one backend call a graph, on the graph's own handle
            scored = [self._score_graph(g, f) for g, f in enumerate(fines)]
            return tuple(np.stack(col, axis=1) for col in zip(*scored))
        host = [torch.as_tensor(f).cpu().numpy() for f in fines]
        T, B = host[0].shape[:2]
        G = len(host)
        rewards = np.empty((T, G, B))
        latencies = np.empty((T, G, B))
        for t in range(T):                # the reference's (t, g, b) order
            for g in range(G):
                nn = self._nodes(g, host[g].shape[2])
                for b in range(B):
                    rewards[t, g, b], latencies[t, g, b] = \
                        self.reward_fn(host[g][t, b, :nn])
        return rewards, latencies
