"""Window rollout and its Eq.-14 replay for B chains on one graph.

Port of ``repro/core/sim/rollout.py::RolloutEngine.rollout_window`` /
``window_grads`` at G=1.  The reference samples with per-step PRNG keys and
replays the window differentiably from the same keys.  Here the sampling
pass runs under ``torch.no_grad()`` and records what the replay needs to
retrace the identical window: each step's edge keep-masks, its cluster
labels and its sampled coarse actions.  The replay re-runs the T steps with
autograd on exactly those draws; with the same parameters it computes the
same labels and scores the same actions, so the gradient is the reference's
Eq. 14 including the GPN's straight-through gates.

Random draws come from :class:`ChainStreams` (one ``torch.Generator`` per
chain) or are injected whole as a :class:`WindowNoise` — the tests feed the
reference's own masks and Gumbel noise that way.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ...kernels.gcn_spmm import GCNGraph

__all__ = ["ChainStreams", "WindowNoise", "WindowRecord", "RolloutEngine"]


class WindowNoise(NamedTuple):
    """Injected random draws for a whole window."""

    keep: torch.Tensor     # (T, B, E) 0/1 — edge dropout keep-mask
    gumbel: torch.Tensor   # (T, B, V, D) — Gumbel noise of the action sample


class WindowRecord(NamedTuple):
    """What the sampling pass drew and decided, per step."""

    keep: torch.Tensor     # (T, B, E) f32
    labels: torch.Tensor   # (T, B, V) i64
    actions: torch.Tensor  # (T, B, V) i64 — coarse placement per slot


class ChainStreams:
    """One generator per chain on ``device``.

    Chain b's stream depends only on (seed, b), so chain 0 draws the same
    numbers whatever the number of chains.
    """

    def __init__(self, seed: int, num_chains: int, device):
        self.generators = []
        for b in range(num_chains):
            state = np.random.SeedSequence([seed, b]).generate_state(2)
            g = torch.Generator(device=device)
            g.manual_seed(int(state[0]) << 32 | int(state[1]))
            self.generators.append(g)
        self.device = torch.device(device)

    def draw(self, num_edges: int, num_nodes: int, num_devices: int,
             edge_dropout: float):
        """→ keep (B, E) f32 0/1 with P(keep) = 1 − edge_dropout, and Gumbel
        noise (B, V, D)."""
        tiny = torch.finfo(torch.float32).tiny
        keep, gumbel = [], []
        for g in self.generators:
            u = torch.rand(num_edges + num_nodes * num_devices, generator=g,
                           device=self.device)
            keep.append((u[:num_edges] < 1.0 - edge_dropout).float())
            ug = u[num_edges:].clamp_min(tiny).reshape(num_nodes,
                                                       num_devices)
            gumbel.append(-torch.log(-torch.log(ug)))
        return torch.stack(keep), torch.stack(gumbel)


class RolloutEngine:
    """Samples and replays rollout windows of one graph for B chains.

    ``policy`` is the port's ``HSDAGPolicy``; its ``step`` is one Alg.-1
    iteration.  ``x0`` (V, d) holds the graph's initial features.
    """

    def __init__(self, policy, cfg, *, x0: torch.Tensor, graph: GCNGraph):
        self.policy = policy
        self.cfg = cfg
        self.x0 = x0
        self.graph = graph

    def _x0(self, num_chains: int) -> torch.Tensor:
        return self.x0.expand(num_chains, *self.x0.shape)

    def rollout_window(self, z: torch.Tensor, *, num_steps: int,
                       start_first: bool,
                       streams: Optional[ChainStreams] = None,
                       noise: Optional[WindowNoise] = None):
        """Sample ``num_steps`` steps of every chain from state z (B, V, ·).

        → (z_final, record, fines (T, B, V) i64, ngroups (T, B) i64).
        """
        if (streams is None) == (noise is None):
            raise ValueError("pass exactly one of streams= or noise=")
        B = z.shape[0]
        V, E = self.graph.num_nodes, self.graph.num_edges
        x0 = self._x0(B)
        keeps, labels, actions, fines, ngroups = [], [], [], [], []
        with torch.no_grad():
            for t in range(num_steps):
                if noise is not None:
                    keep, gumbel = noise.keep[t].float(), noise.gumbel[t]
                else:
                    keep, gumbel = streams.draw(
                        E, V, self.cfg.num_devices, self.cfg.dropout_network)
                out = self.policy.step(z, x0, self.graph, keep,
                                       first=start_first and t == 0,
                                       state_norm=self.cfg.state_norm,
                                       gumbel=gumbel)
                keeps.append(keep)
                labels.append(out.parse.labels)
                actions.append(out.policy.coarse_placement)
                fines.append(out.policy.fine_placement)
                ngroups.append(out.parse.num_groups)
                z = out.z_next
        record = WindowRecord(torch.stack(keeps), torch.stack(labels),
                              torch.stack(actions))
        return z, record, torch.stack(fines), torch.stack(ngroups)

    def window_grads(self, z0: torch.Tensor, record: WindowRecord,
                     weights: torch.Tensor, *,
                     start_first: bool) -> List[torch.Tensor]:
        """∇θ of the Eq.-14 loss over the recorded window, averaged over the
        B chains; ``weights`` (T, B).  → one gradient per policy parameter,
        in ``policy.parameters()`` order."""
        B = z0.shape[0]
        x0 = self._x0(B)
        params = list(self.policy.parameters())
        total = torch.zeros((), device=z0.device)
        z = z0
        for t in range(record.keep.shape[0]):
            out = self.policy.step(z, x0, self.graph, record.keep[t],
                                   first=start_first and t == 0,
                                   state_norm=self.cfg.state_norm,
                                   labels=record.labels[t],
                                   actions=record.actions[t])
            loss = -out.policy.logp * weights[t] \
                - self.cfg.entropy_coef * out.policy.entropy
            total = total + loss.sum()
            z = out.z_next
        grads = torch.autograd.grad(total / B, params, allow_unused=True)
        # An edge-free graph leaves φ out of the loss: its gradient is 0.
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(params, grads)]
