"""Graph/node encoder (paper §2.4, Eq. 6) — PyTorch.

Port of ``repro/core/gnn.py``.  The encoder is ``layer_trans`` MLP layers
mapping X^(0) into the hidden width, followed by ``layer_gnn`` graph layers:
``gnn_model="gcn"`` convolves over the symmetric-normalised, self-looped
adjacency (Eq. 6); ``"sage"`` (GraphSAGE) adds a linear map of each node to
one of the mean of its in- and out-neighbours.  The reference multiplies by
dense (V, V) matrices; here every chain has its own edge-dropout mask, so
the aggregations run over the edge list in the ``gcn_aggregate`` and
``sage_aggregate`` kernels and the operators are never formed.

Every tensor carries a leading chain axis B: x (B, V, d), keep (B, E).
Linear weights follow ``nn.Linear`` ((out, in)); the reference stores the
transpose (``checkpoint/convert.py`` maps between them).

``mlp_init`` and ``encoder_init`` build the reference's initial parameter
tree (numpy, (in, out) weights) from a threefry key of ``core/prng.py``,
split as the reference splits it, so the same key gives the same weights.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.gcn_spmm import GCNAggregate, GCNGraph, SageAggregate
from . import prng

__all__ = ["mlp_init", "encoder_init", "MLP", "normalize_adjacency",
           "SageLayer", "Encoder"]


def mlp_init(key: np.ndarray, sizes: Sequence[int]) -> List[Dict]:
    """The reference's ``mlp_init``: one key split off per layer, a Glorot
    weight (in, out) and a zero bias."""
    layers = []
    for a, b in zip(sizes, sizes[1:]):
        key, sub = prng.split(key)
        layers.append({"w": prng.glorot(sub, (a, b)),
                       "b": np.zeros(b, np.float32)})
    return layers


def encoder_init(key: np.ndarray, d_in: int, hidden: int, *,
                 layer_trans: int = 2, layer_gnn: int = 2,
                 gnn_model: str = "gcn") -> Dict:
    """The reference's ``encoder_init`` tree."""
    if gnn_model not in ("gcn", "sage"):
        raise ValueError(f"unknown gnn_model {gnn_model!r}")
    key, k_mlp = prng.split(key)
    tree = {"trans": mlp_init(k_mlp, [d_in] + [hidden] * layer_trans),
            "gnn": []}
    for _ in range(layer_gnn):
        key, sub = prng.split(key)
        if gnn_model == "gcn":
            tree["gnn"].append({"w": prng.glorot(sub, (hidden, hidden))})
        else:
            k1, k2 = prng.split(sub)
            tree["gnn"].append({"w_self": prng.glorot(k1, (hidden, hidden)),
                                "w_nbr": prng.glorot(k2, (hidden, hidden))})
    return tree


class MLP(nn.ModuleList):
    """Stack of ``nn.Linear`` layers with ReLU between them; its forward is
    the reference ``mlp_apply``."""

    def __init__(self, sizes: Sequence[int]):
        super().__init__(nn.Linear(a, b) for a, b in zip(sizes, sizes[1:]))

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


class SageLayer(nn.Module):
    """One GraphSAGE layer, ``z @ w_self + mean_nbr(z) @ w_nbr``; both
    weights stored (out, in) like ``nn.Linear``'s."""

    def __init__(self, hidden: int):
        super().__init__()
        self.w_self = nn.Parameter(torch.empty(hidden, hidden))
        self.w_nbr = nn.Parameter(torch.empty(hidden, hidden))

    def forward(self, z: torch.Tensor, graph: GCNGraph,
                keep: torch.Tensor) -> torch.Tensor:
        nbr = SageAggregate.apply(graph, keep, z.contiguous())
        return F.linear(z, self.w_self) + F.linear(nbr, self.w_nbr)


class Encoder(nn.Module):
    """X^(0) → Z (Eq. 6) for a batch of chains."""

    def __init__(self, d_in: int, hidden: int, *, layer_trans: int = 2,
                 layer_gnn: int = 2, gnn_model: str = "gcn"):
        super().__init__()
        if gnn_model not in ("gcn", "sage"):
            raise ValueError(f"unknown gnn_model {gnn_model!r}")
        self.gnn_model = gnn_model
        self.trans = MLP([d_in] + [hidden] * layer_trans)
        if gnn_model == "sage":
            self.gnn = nn.ModuleList(SageLayer(hidden)
                                     for _ in range(layer_gnn))
        else:
            self.gnn = nn.ModuleList(nn.Linear(hidden, hidden, bias=False)
                                     for _ in range(layer_gnn))

    def forward(self, x: torch.Tensor, graph: GCNGraph, keep: torch.Tensor,
                *, transform: bool = True) -> torch.Tensor:
        """x (B, V, d), keep (B, E) 0/1 edge mask → (B, V, hidden).

        ``transform=False`` skips the input MLP — rounds ≥ 1 of the
        multi-round rollout (Alg. 1 line 12), where the state is already at
        the hidden width.
        """
        z = self.trans(x, act_final=True) if transform else x
        for i, layer in enumerate(self.gnn):
            if self.gnn_model == "sage":
                z = layer(z, graph, keep)
            else:
                z = GCNAggregate.apply(graph, keep, layer(z).contiguous())
            if i < len(self.gnn) - 1:
                z = torch.relu(z)
        return z
