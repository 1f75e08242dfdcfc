"""RewardPipeline — turns a rollout window's placements into rewards.

Port of ``repro/core/sim/pipeline.py`` for a single graph.  Two reward
sources: a registered simulator backend, whose :meth:`score_window` scores
the (T, B, V) placements of one window in one backend call (one kernel
launch for ``scan`` and ``level``), or a host callable ``reward_fn``
(a measured executor's slot), called once per placement in the reference's
(t, b) order.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .base import SimulatorBackend, get_backend

__all__ = ["RewardPipeline"]


class RewardPipeline:
    """Scores rollout windows of one graph; see module docstring."""

    def __init__(self, *, backend: Optional[SimulatorBackend] = None,
                 prep=None, reward_fn: Optional[Callable] = None,
                 num_nodes: Optional[int] = None):
        if (backend is None) == (reward_fn is None):
            raise ValueError("pass exactly one of backend= or reward_fn=")
        self.backend = backend
        self.prep = prep
        self.reward_fn = reward_fn
        self.num_nodes = int(num_nodes) if num_nodes is not None else None

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
        return cls(reward_fn=reward_fn, num_nodes=num_nodes)

    @classmethod
    def from_platform(cls, graph, platform, backend: str = "scan", *,
                      device="cuda") -> "RewardPipeline":
        """Single-graph pipeline over a registered simulator backend."""
        b = get_backend(backend, device=device) \
            if isinstance(backend, str) else backend
        return cls(backend=b, prep=b.prepare(graph, platform),
                   num_nodes=graph.num_nodes)

    def score_window(self, fines):
        """(T, B, V) placements (tensor or array) → (rewards, latencies),
        each (T, B) float64 on the host."""
        if fines.ndim != 3:
            raise ValueError(f"expected (T, B, V) placements; got "
                             f"{tuple(fines.shape)}")
        T, B, V = fines.shape
        nn = self.num_nodes if self.num_nodes is not None else V
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
            self.prep, fines[:, :, :nn].reshape(T * B, nn))
        return (np.asarray(res.reward, np.float64).reshape(T, B),
                np.asarray(res.latency, np.float64).reshape(T, B))
