"""Graph Parsing Network (paper §2.4, Eq. 7–11; Alg. 2) — PyTorch.

Port of ``repro/core/gpn.py``, batched over a leading chain axis B.  Jointly
learns *how many* groups a computation graph is split into and *which* nodes
join each group:

  1. edge scores       S_{v,u} = σ(φ(z_v ⊙ z_u)), masked by A        (Eq. 7)
  2. dominant edges    E' = {(v, argmax_{u∈N(v)} S_{v,u})}            (Eq. 9)
  3. clusters          connected components of E'  →  labels         (Eq. 10)
  4. pooled features   Z' = Xᵀ(Z·gate)                                (Eq. 11)

Cluster ids live in [0, V) (the minimum member index of each component) and
an ``active`` mask marks occupied slots, so the number of groups is emergent.
Each node's pooled contribution is gated by its dominant edge score with a
straight-through estimator, so ∂loss/∂φ exists while the forward pass stays
an exact sum.  The pooled adjacency A' of the reference is not formed: no
later stage of the search reads it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from .gnn import MLP

__all__ = ["GPN", "edge_scores", "parse_graph", "gpn_apply", "ParseResult"]


class ParseResult(NamedTuple):
    labels: torch.Tensor                # (B, V) i64 — component id
    pooled_z: torch.Tensor              # (B, V, d) — Z' (zero inactive rows)
    active: torch.Tensor                # (B, V) bool — occupied slots
    scores: torch.Tensor                # (B, E) — per-edge sigmoid scores
    retained: Optional[torch.Tensor]    # (B, E) bool — Eq. 9 dominant edges
    num_groups: torch.Tensor            # (B,) i64


class GPN(nn.Module):
    """φ of Eq. 7 — an MLP from the hidden width to a scalar logit."""

    def __init__(self, hidden: int, *, layer_parsingnet: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.phi = MLP([hidden] * layer_parsingnet + [1], generator)


def edge_scores(gpn: GPN, z: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor) -> torch.Tensor:
    """Eq. 7 per existing edge: σ(φ(z_src ⊙ z_dst)) → (B, E)."""
    return torch.sigmoid(gpn.phi(z[:, src] * z[:, dst])[..., 0])


def _dominant_edges(scores: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Eq. 9 — an edge survives if it is the max-score incident edge of
    either endpoint (N = in ∪ out).  Ties keep every tied edge."""
    B = scores.shape[0]
    node_max = torch.full((B, num_nodes), float("-inf"), dtype=scores.dtype,
                          device=scores.device)
    idx_s = src.expand(B, -1)
    idx_d = dst.expand(B, -1)
    node_max = node_max.scatter_reduce(1, idx_s, scores, "amax")
    node_max = node_max.scatter_reduce(1, idx_d, scores, "amax")
    return (scores >= node_max.gather(1, idx_s)) \
        | (scores >= node_max.gather(1, idx_d))


def _connected_components(src: torch.Tensor, dst: torch.Tensor,
                          retained: torch.Tensor,
                          num_nodes: int) -> torch.Tensor:
    """Min-label propagation over the retained edges → (B, V) labels.

    Each round propagates labels across retained edges (the reference's
    round) and then shortcuts every label to its label's label.  Labels only
    fall and stay inside their component, so the fixpoint is the reference's:
    every node labelled with the minimum index of its component.  Rounds run
    in groups of four between convergence checks (extra rounds at the
    fixpoint change nothing), which bounds the host round trips.
    """
    B = retained.shape[0]
    big = num_nodes
    labels = torch.arange(num_nodes, device=retained.device).expand(
        B, -1).contiguous()
    idx_s = src.expand(B, -1)
    idx_d = dst.expand(B, -1)
    for _ in range(num_nodes):
        prev = labels
        for _ in range(4):
            ls = torch.where(retained, labels.gather(1, idx_s), big)
            ld = torch.where(retained, labels.gather(1, idx_d), big)
            labels = labels.scatter_reduce(1, idx_d, ls, "amin")
            labels = labels.scatter_reduce(1, idx_s, ld, "amin")
            labels = labels.gather(1, labels)
        if torch.equal(labels, prev):
            break
    return labels


def parse_graph(scores: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                z: torch.Tensor, *,
                labels: Optional[torch.Tensor] = None) -> ParseResult:
    """Eq. 9–11: dominant edges → components → Z'.

    ``labels`` (B, V) skips Eq. 9–10 and pools with given labels — the
    Eq.-14 replay passes the labels its sampling pass found, which the same
    parameters would find again.
    """
    B, num_nodes = z.shape[0], z.shape[1]
    if src.shape[0] == 0:
        labels = torch.arange(num_nodes, device=z.device).expand(B, -1)
        active = torch.ones(B, num_nodes, dtype=torch.bool, device=z.device)
        return ParseResult(labels, z, active, scores, None,
                           active.sum(1))
    retained = None
    if labels is None:
        retained = _dominant_edges(scores, src, dst, num_nodes)
        labels = _connected_components(src, dst, retained, num_nodes)

    counts = torch.zeros(B, num_nodes, dtype=torch.long, device=z.device)
    counts.scatter_add_(1, labels, torch.ones_like(labels))
    active = counts > 0

    # Differentiable gate: a node contributes through its dominant edge
    # score (straight-through: 1 forward, the score's gradient backward);
    # nodes without edges pass through with gate 1.
    gate = torch.zeros(B, num_nodes, dtype=scores.dtype, device=z.device)
    gate = gate.scatter_reduce(1, src.expand(B, -1), scores, "amax")
    gate = gate.scatter_reduce(1, dst.expand(B, -1), scores, "amax")
    has_edge = torch.zeros(num_nodes, dtype=torch.bool, device=z.device)
    has_edge[src] = True
    has_edge[dst] = True
    gate = torch.where(has_edge, gate, torch.ones_like(gate))
    gate = gate + (1.0 - gate).detach()

    pooled_z = torch.zeros_like(z).scatter_add(
        1, labels[..., None].expand_as(z), z * gate[..., None])
    return ParseResult(labels, pooled_z, active, scores, retained,
                       active.sum(1))


def gpn_apply(gpn: GPN, z: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor, *,
              labels: Optional[torch.Tensor] = None) -> ParseResult:
    """Full §2.4 grouping step: scores (Eq. 7) then parse (Eq. 9–11)."""
    return parse_graph(edge_scores(gpn, z, src, dst), src, dst, z,
                       labels=labels)
