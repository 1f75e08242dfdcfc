"""GCN aggregation kernel — the HSDAG encoder's Eq.-6 hot spot.

Port of ``repro/kernels/gcn_spmm.py``.  Computes, for every chain b,

    out[b] = D̂_b^{-1/2} (Â_b + Â_bᵀ − diag Â_b) D̂_b^{-1/2} · h[b],
    Â_b = A ⊙ keep_b + I,

with degrees counted symmetrically, exactly ``normalize_adjacency(adj) @ h``
of the reference encoder.  Each chain has its own edge-dropout mask, so the
operator is never formed: the kernel walks a CSR of the symmetrised
neighbour lists (:class:`GCNGraph`, built once per graph on the host) with a
(B, E) keep mask.  The self loop is never dropped.

``gcn_aggregate`` launches the CUDA kernel ``csrc/gcn_spmm.cu`` on CUDA
tensors and runs the plain PyTorch version ``gcn_aggregate_ref`` on CPU
tensors.  ``GCNAggregate`` is its autograd function: the operator is
symmetric, so the gradient with respect to ``h`` is the same kernel applied
to the output gradient with the same keep mask.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["GCNGraph", "gcn_graph", "gcn_aggregate_ref", "gcn_aggregate",
           "GCNAggregate"]


class GCNGraph(NamedTuple):
    """One graph's edge list and symmetrised CSR on one device.

    Row i of the CSR lists i's neighbours: first the edges where i is the
    source, then those where i is the destination, each in edge order (the
    order the plain version sums in).  ``eid`` maps a CSR entry to its edge,
    i.e. to its column of the (B, E) keep mask.
    """

    src: torch.Tensor      # (E,) i64
    dst: torch.Tensor      # (E,) i64
    rowptr: torch.Tensor   # (V+1,) i32
    col: torch.Tensor      # (2E,) i32 — neighbour node
    eid: torch.Tensor      # (2E,) i32 — edge index into keep
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def gcn_graph(edges, num_nodes: int, device) -> GCNGraph:
    """Build the CSR of ``edges`` ((E, 2) src→dst) for ``num_nodes`` nodes.

    The dense reference adjacency is binary, so a repeated (src, dst) row
    would count twice here and once there: such rows, self loops and
    out-of-range ids raise.
    """
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    if e.size and (e.min() < 0 or e.max() >= num_nodes):
        raise ValueError(f"edge ids must be in [0, {num_nodes})")
    if np.any(e[:, 0] == e[:, 1]):
        raise ValueError("self loops are not edges of a computation graph")
    if len(np.unique(e, axis=0)) != len(e):
        raise ValueError("repeated (src, dst) edge rows: the dense adjacency "
                         "counts an edge once")
    n_e = e.shape[0]
    ends = np.concatenate([e[:, 0], e[:, 1]])          # row of each entry
    nbrs = np.concatenate([e[:, 1], e[:, 0]])
    eids = np.concatenate([np.arange(n_e), np.arange(n_e)])
    perm = np.argsort(ends, kind="stable")
    rowptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(rowptr, ends + 1, 1)
    rowptr = np.cumsum(rowptr)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return GCNGraph(put(e[:, 0], torch.long), put(e[:, 1], torch.long),
                    put(rowptr, torch.int32), put(nbrs[perm], torch.int32),
                    put(eids[perm], torch.int32), int(num_nodes))


def gcn_aggregate_ref(graph: GCNGraph, keep: torch.Tensor,
                      h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: keep (B, E), h (B, V, F) → (B, V, F)."""
    src, dst = graph.src, graph.dst
    B, V = h.shape[0], h.shape[1]
    keep = keep.to(h.dtype)
    deg = torch.ones(B, V, dtype=h.dtype, device=h.device)
    deg = deg.index_add(1, src, keep).index_add(1, dst, keep)
    r = 1.0 / torch.sqrt(deg)
    acc = r[..., None] * h
    acc = acc.index_add(1, src, (keep * r[:, dst])[..., None] * h[:, dst])
    acc = acc.index_add(1, dst, (keep * r[:, src])[..., None] * h[:, src])
    return r[..., None] * acc


def _lib():
    from ._build import library
    fn = library("gcn_spmm").gcn_aggregate_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    return fn


def gcn_aggregate(graph: GCNGraph, keep: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """keep (B, E) 0/1 f32, h (B, V, F) f32 → (B, V, F).

    CUDA tensors launch ``csrc/gcn_spmm.cu``; CPU tensors take
    ``gcn_aggregate_ref``.
    """
    if h.device.type == "cpu":
        return gcn_aggregate_ref(graph, keep, h)
    if h.device.type != "cuda":
        raise ValueError(f"gcn_aggregate takes CPU or CUDA tensors; got "
                         f"{h.device}")
    if h.ndim != 3 or h.dtype != torch.float32 or not h.is_contiguous():
        raise ValueError(f"gcn_aggregate: h must be a contiguous (B, V, F) "
                         f"float32 tensor; got {h.dtype} {tuple(h.shape)}")
    B, V, F = h.shape
    E = graph.num_edges
    if V != graph.num_nodes:
        raise ValueError(f"gcn_aggregate: h has {V} nodes, the graph "
                         f"{graph.num_nodes}")
    for name, t, dtype, shape in (
            ("keep", keep, torch.float32, (B, E)),
            ("rowptr", graph.rowptr, torch.int32, (V + 1,)),
            ("col", graph.col, torch.int32, (2 * E,)),
            ("eid", graph.eid, torch.int32, (2 * E,))):
        if t.device != h.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"gcn_aggregate: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {h.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out
    rscale = torch.empty(B, V, dtype=torch.float32, device=h.device)
    err = _lib()(graph.rowptr.data_ptr(), graph.col.data_ptr(),
                 graph.eid.data_ptr(), keep.data_ptr(), h.data_ptr(),
                 rscale.data_ptr(), out.data_ptr(), B, V, E, F,
                 torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gcn_aggregate kernel launch failed: CUDA "
                           f"error {err}")
    gcn_aggregate.launches += 1
    return out


gcn_aggregate.launches = 0


class GCNAggregate(torch.autograd.Function):
    """``gcn_aggregate`` with its gradient with respect to ``h``.

    The normalised operator is symmetric, so its transpose is itself: the
    backward is one more aggregation of the output gradient with the same
    keep mask.  ``graph`` and ``keep`` take no gradient.
    """

    @staticmethod
    def forward(ctx, graph: GCNGraph, keep: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
        ctx.graph = graph
        ctx.save_for_backward(keep)
        return gcn_aggregate(graph, keep, h)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        (keep,) = ctx.saved_tensors
        return None, None, gcn_aggregate(ctx.graph, keep,
                                         grad_out.contiguous())
