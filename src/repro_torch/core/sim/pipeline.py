"""RewardPipeline — turns a rollout window's placements into rewards.

Port of ``repro/core/sim/pipeline.py`` for a single graph and a registered
simulator backend: :meth:`RewardPipeline.score_window` scores the (T, B, V)
placements of one window in one backend call.
"""
from __future__ import annotations

import numpy as np

from .base import SimulatorBackend, get_backend

__all__ = ["RewardPipeline"]


class RewardPipeline:
    """Scores rollout windows of one graph against one prepared backend."""

    def __init__(self, backend: SimulatorBackend, prep, num_nodes: int):
        self.backend = backend
        self.prep = prep
        self.num_nodes = int(num_nodes)

    @classmethod
    def from_platform(cls, graph, platform, backend: str = "level", *,
                      device="cuda") -> "RewardPipeline":
        """Single-graph pipeline over a registered simulator backend."""
        b = get_backend(backend, device=device) \
            if isinstance(backend, str) else backend
        return cls(b, b.prepare(graph, platform), graph.num_nodes)

    def score_window(self, fines):
        """(T, B, V) placements (tensor or array) → (rewards, latencies),
        each (T, B) float64 on the host."""
        if fines.ndim != 3:
            raise ValueError(f"expected (T, B, V) placements; got "
                             f"{tuple(fines.shape)}")
        T, B, V = fines.shape
        res = self.backend.simulate_batch(
            self.prep, fines[:, :, :self.num_nodes].reshape(T * B,
                                                           self.num_nodes))
        return (np.asarray(res.reward, np.float64).reshape(T, B),
                np.asarray(res.latency, np.float64).reshape(T, B))
