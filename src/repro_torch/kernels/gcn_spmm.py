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

The same source holds the GraphSAGE encoder's mean aggregation,
``sage_aggregate`` (``SageAggregate`` with its gradient):

    out[b, i] = Σ_{e ∈ N(i)} keep_b(e) · h[b, j] / max(deg_b(i), 1),

over in- and out-neighbours, with no self loop.  The reference computes it
as the dense ``((A + Aᵀ) @ z) / deg`` outside any Pallas kernel; its plain
version here, ``sage_aggregate_ref``, is that dense formula per chain.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["GCNGraph", "gcn_graph", "gcn_aggregate_ref", "gcn_aggregate",
           "GCNAggregate", "sage_aggregate_ref", "sage_aggregate",
           "SageAggregate"]


@dataclass(frozen=True, eq=False)
class GCNGraph:
    """One graph's edge list and symmetrised CSR on one device.

    Row i of the CSR lists i's neighbours: first the edges where i is the
    source, then those where i is the destination, each in edge order (the
    order the plain version sums in).  ``eid`` maps a CSR entry to its edge,
    i.e. to its column of the (B, E) keep mask.  ``csr`` holds each entry
    as the kernel loads it, in one 16-byte record: the neighbour j, the
    edge, and the bounds of j's own row (``rowptr[j]``, ``rowptr[j + 1]``),
    so the kernel finds j's degree without a load of ``rowptr`` in between.

    The tensors are checked once, here: one device, the dtypes and shapes
    below, contiguous, and counts that fit the kernel's int32 indices.  So a
    launch checks only ``h`` and ``keep`` against the graph.
    """

    src: torch.Tensor      # (E,) i64
    dst: torch.Tensor      # (E,) i64
    rowptr: torch.Tensor   # (V+1,) i32
    csr: torch.Tensor      # (2E, 4) i32 — neighbour, edge, its row bounds
    eid: torch.Tensor      # (2E,) i32 — edge index into keep
    num_nodes: int

    def __post_init__(self):
        v, e = self.num_nodes, self.num_edges
        if not 0 <= v < 2 ** 31 - 1 or 2 * e >= 2 ** 31:
            raise ValueError(f"GCNGraph: {v} nodes and {e} edges exceed the "
                             f"kernel's int32 CSR")
        for name, dtype, shape in (("src", torch.long, (e,)),
                                   ("dst", torch.long, (e,)),
                                   ("rowptr", torch.int32, (v + 1,)),
                                   ("csr", torch.int32, (2 * e, 4)),
                                   ("eid", torch.int32, (2 * e,))):
            t = getattr(self, name)
            if t.device != self.device or t.dtype != dtype \
                    or tuple(t.shape) != shape or not t.is_contiguous() \
                    or (name == "csr" and t.data_ptr() % 16):
                raise ValueError(
                    f"GCNGraph: {name} must be a contiguous {dtype} tensor "
                    f"of shape {shape} on {self.device} (csr on a 16-byte "
                    f"boundary); got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.rowptr.device


def gcn_graph(edges, num_nodes: int, device) -> GCNGraph:
    """Build the CSR of ``edges`` ((E, 2) src→dst) for ``num_nodes`` nodes.

    The dense reference adjacency is binary, so it counts a repeated
    (src, dst) row once: the graph keeps each edge's first row, in the order
    of first occurrence (a graph without repeats keeps its edge ids), and has
    one keep-mask column per unique edge.  Self loops and out-of-range ids
    raise.
    """
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    if e.size and (e.min() < 0 or e.max() >= num_nodes):
        raise ValueError(f"edge ids must be in [0, {num_nodes})")
    if np.any(e[:, 0] == e[:, 1]):
        raise ValueError("self loops are not edges of a computation graph")
    _, first = np.unique(e, axis=0, return_index=True)
    e = e[np.sort(first)]
    n_e = e.shape[0]
    ends = np.concatenate([e[:, 0], e[:, 1]])          # row of each entry
    nbrs = np.concatenate([e[:, 1], e[:, 0]])
    eids = np.concatenate([np.arange(n_e), np.arange(n_e)])
    perm = np.argsort(ends, kind="stable")
    rowptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(rowptr, ends + 1, 1)
    rowptr = np.cumsum(rowptr)

    col = nbrs[perm]
    csr = np.stack([col, eids[perm], rowptr[col], rowptr[col + 1]], 1)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return GCNGraph(put(e[:, 0], torch.long), put(e[:, 1], torch.long),
                    put(rowptr, torch.int32), put(csr, torch.int32),
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


@functools.cache
def _lib(entry: str = "gcn_aggregate_f32"):
    from ._build import library
    fn = getattr(library("gcn_spmm"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    return fn


def _check_cuda_operands(what: str, graph: GCNGraph, keep: torch.Tensor,
                         h: torch.Tensor) -> None:
    """A launch's own operands against the graph (whose tensors were checked
    when it was built)."""
    if not h.is_cuda:
        raise ValueError(f"{what} takes CPU or CUDA tensors; got {h.device}")
    if h.ndim != 3 or h.dtype != torch.float32 or not h.is_contiguous():
        raise ValueError(f"{what}: h must be a contiguous (B, V, F) float32 "
                         f"tensor; got {h.dtype} {tuple(h.shape)}")
    B, V, F = h.shape
    E = graph.num_edges
    dev = h.get_device()
    if V != graph.num_nodes or not graph.rowptr.is_cuda \
            or graph.rowptr.get_device() != dev:
        raise ValueError(f"{what}: h has {V} nodes on {h.device}, the graph "
                         f"{graph.num_nodes} on {graph.device}")
    if not keep.is_cuda or keep.get_device() != dev \
            or keep.dtype != torch.float32 or keep.shape != (B, E) \
            or not keep.is_contiguous():
        raise ValueError(
            f"{what}: keep must be a contiguous float32 tensor of shape "
            f"{(B, E)} on {h.device}; got {keep.dtype} {tuple(keep.shape)} "
            f"on {keep.device}")
    if B * V >= 2 ** 31 or F >= 2 ** 31:
        raise ValueError(f"{what}: B·V = {B * V} and F = {F} must each fit "
                         f"the kernel's int32")


def gcn_aggregate(graph: GCNGraph, keep: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """keep (B, E) 0/1 f32, h (B, V, F) f32 → (B, V, F).

    CUDA tensors launch ``csrc/gcn_spmm.cu`` (one launch: degrees and
    aggregation); CPU tensors take ``gcn_aggregate_ref``.  The graph's own
    tensors were checked when it was built, so only ``h`` and ``keep`` are
    checked here.
    """
    if h.is_cpu:
        return gcn_aggregate_ref(graph, keep, h)
    _check_cuda_operands("gcn_aggregate", graph, keep, h)
    B, V, F = h.shape
    E = graph.num_edges
    dev = h.get_device()
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out
    hp = h.data_ptr()
    route = "vec4" if F % 4 == 0 and hp % 16 == 0 else "scalar"
    err = _lib()(graph.rowptr.data_ptr(), graph.csr.data_ptr(),
                 graph.eid.data_ptr(), keep.data_ptr(), hp, out.data_ptr(),
                 B, V, E, F, route == "vec4",
                 torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"gcn_aggregate kernel launch failed ({route}): "
                           f"CUDA error {err}")
    gcn_aggregate.launches += 1
    gcn_aggregate.route_launches[route] += 1
    return out


gcn_aggregate.launches = 0
#: launches per route: float4 loads, 16 lanes a row (F a multiple of 4), or
#: scalar loads, 8 lanes a row
gcn_aggregate.route_launches = {"vec4": 0, "scalar": 0}


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


def sage_aggregate_ref(graph: GCNGraph, keep: torch.Tensor, h: torch.Tensor,
                       *, prescale: bool = False) -> torch.Tensor:
    """Plain PyTorch version, the reference's dense formula per chain:
    S_b = A⊙keep_b + (A⊙keep_b)ᵀ, deg_b = max(S_b·1, 1), and
    ``(S_b @ h_b) / deg_b`` — or, with ``prescale``, its transpose
    ``S_b @ (h_b / deg_b)``.  keep (B, E), h (B, V, F) → (B, V, F)."""
    B, V = h.shape[0], h.shape[1]
    adj = torch.zeros(B, V, V, dtype=h.dtype, device=h.device)
    bidx = torch.arange(B, device=h.device)[:, None]
    adj[bidx, graph.src[None], graph.dst[None]] = keep.to(h.dtype)
    deg = torch.clamp(adj.sum(1) + adj.sum(2), min=1.0)[..., None]
    sym = adj + adj.transpose(1, 2)
    if prescale:
        return torch.bmm(sym, h / deg)
    return torch.bmm(sym, h) / deg


def sage_aggregate(graph: GCNGraph, keep: torch.Tensor, h: torch.Tensor, *,
                   prescale: bool = False) -> torch.Tensor:
    """keep (B, E) 0/1 f32, h (B, V, F) f32 → (B, V, F): the mean over each
    node's kept in- and out-neighbours (``prescale``: the transpose).

    CUDA tensors launch the ``sage_aggregate_f32`` entry of
    ``csrc/gcn_spmm.cu``; CPU tensors take ``sage_aggregate_ref``.
    """
    if h.is_cpu:
        return sage_aggregate_ref(graph, keep, h, prescale=prescale)
    _check_cuda_operands("sage_aggregate", graph, keep, h)
    B, V, F = h.shape
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out
    err = _lib("sage_aggregate_f32")(
        graph.rowptr.data_ptr(), graph.csr.data_ptr(), graph.eid.data_ptr(),
        keep.data_ptr(), h.data_ptr(), out.data_ptr(), B, V,
        graph.num_edges, F, int(prescale),
        torch._C._cuda_getCurrentRawStream(h.get_device()))
    if err != 0:
        raise RuntimeError(f"sage_aggregate kernel launch failed: CUDA "
                           f"error {err}")
    sage_aggregate.launches += 1
    return out


sage_aggregate.launches = 0


class SageAggregate(torch.autograd.Function):
    """``sage_aggregate`` with its gradient with respect to ``h``.

    The forward is D⁻¹S h with S symmetric; its transpose S D⁻¹ is the same
    kernel with the degree applied to each neighbour's term instead of the
    row's sum.  ``graph`` and ``keep`` take no gradient.
    """

    @staticmethod
    def forward(ctx, graph: GCNGraph, keep: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
        ctx.graph = graph
        ctx.save_for_backward(keep)
        return sage_aggregate(graph, keep, h)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        (keep,) = ctx.saved_tensors
        return None, None, sage_aggregate(ctx.graph, keep,
                                          grad_out.contiguous(),
                                          prescale=True)
