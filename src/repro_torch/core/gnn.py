"""Graph/node encoder (paper §2.4, Eq. 6) — PyTorch.

Port of ``repro/core/gnn.py`` for ``gnn_model="gcn"``.  The encoder is
``layer_trans`` MLP layers mapping X^(0) into the hidden width, followed by
``layer_gnn`` graph-convolution layers over the symmetric-normalised,
self-looped adjacency (Eq. 6).  The reference multiplies by the dense
normalised matrix; here every chain has its own edge-dropout mask, so the
aggregation runs over the edge list in the ``gcn_aggregate`` kernel and the
(V, V) operator is never formed.

Every tensor carries a leading chain axis B: x (B, V, d), keep (B, E).
Linear weights follow ``nn.Linear`` ((out, in)); the reference stores the
transpose (``checkpoint/convert.py`` maps between them).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels.gcn_spmm import GCNAggregate, GCNGraph

__all__ = ["glorot_", "MLP", "normalize_adjacency", "Encoder"]


def glorot_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Uniform(±sqrt(6 / (fan_in + fan_out))) in place, the reference init."""
    fan_out, fan_in = weight.shape
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.copy_(torch.rand(weight.shape, generator=generator,
                                dtype=weight.dtype) * (2 * lim) - lim)


class MLP(nn.ModuleList):
    """Stack of ``nn.Linear`` layers with ReLU between them; its forward is
    the reference ``mlp_apply``."""

    def __init__(self, sizes: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__(nn.Linear(a, b) for a, b in zip(sizes, sizes[1:]))
        if generator is not None:
            for layer in self:
                glorot_(layer.weight, generator)
                nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor, act_final: bool = False):
        for i, layer in enumerate(self):
            x = layer(x)
            if i < len(self) - 1 or act_final:
                x = torch.relu(x)
        return x


def normalize_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """D̂^{-1/2} Â D̂^{-1/2} with Â = A + I (Eq. 6), dense, on a (V, V) or
    (B, V, V) adjacency.  The reference formula the aggregation kernel is
    tested against; the encoder never forms it.
    """
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)
    a = adj + eye
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    deg = a.sum(-1) + a.sum(-2) - diag
    inv_sqrt = torch.where(deg > 0, 1.0 / torch.sqrt(deg),
                           torch.zeros_like(deg))
    sym = a + a.transpose(-1, -2) - diag[..., None] * eye
    return inv_sqrt[..., :, None] * sym * inv_sqrt[..., None, :]


class Encoder(nn.Module):
    """X^(0) → Z (Eq. 6) for a batch of chains."""

    def __init__(self, d_in: int, hidden: int, *, layer_trans: int = 2,
                 layer_gnn: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.trans = MLP([d_in] + [hidden] * layer_trans, generator)
        self.gnn = nn.ModuleList(nn.Linear(hidden, hidden, bias=False)
                                 for _ in range(layer_gnn))
        if generator is not None:
            for layer in self.gnn:
                glorot_(layer.weight, generator)

    def forward(self, x: torch.Tensor, graph: GCNGraph, keep: torch.Tensor,
                *, transform: bool = True) -> torch.Tensor:
        """x (B, V, d), keep (B, E) 0/1 edge mask → (B, V, hidden).

        ``transform=False`` skips the input MLP — rounds ≥ 1 of the
        multi-round rollout (Alg. 1 line 12), where the state is already at
        the hidden width.
        """
        z = self.trans(x, act_final=True) if transform else x
        for i, layer in enumerate(self.gnn):
            z = GCNAggregate.apply(graph, keep, layer(z).contiguous())
            if i < len(self.gnn) - 1:
                z = torch.relu(z)
        return z
