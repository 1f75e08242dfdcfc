"""The LM kernels on DTensors: each rank runs the kernel on its local slice.

A ctypes launch takes a plain tensor's ``data_ptr()``, so under a mesh the
wrappers redistribute their DTensor inputs to the layouts the kernel can
run on locally, call themselves on ``to_local()`` tensors and wrap the local
output with ``DTensor.from_local``.  Both are differentiable, so the local
kernel's autograd Function runs inside and the gradients come back as
DTensors with the placements below.

* ``rmsnorm``: rows may be sharded any way; the normalised (last) dim is
  gathered.  The scale is replicated; its gradient is each rank's partial
  sum over its rows (``Partial`` on every mesh dim that shards the rows).
* ``flash_attention``: batch (dim 0) and heads (dim 1) may be sharded;
  sequence and head dim are gathered.  Heads stay sharded only over one
  mesh dim that divides both the query and the KV heads, so that K and V
  shard with their query groups; otherwise they are gathered.
* ``ssd_scan``: batch (dim 0) and heads (dim 2) may be sharded; chunks and
  the state dims are gathered.

Three plain ops go the same way, for DTensor in torch 2.11 has no strategy
for them: the embedding's row gather (``embedding_local``: the table
gathered whole, each rank's own token rows gathered locally, so that its
backward is the plain ``index_put`` on the rank's rows), and ``cumsum``
(whose backward flips) and ``roll`` along one dim (``along``).
"""
from __future__ import annotations

import torch

from ._work import is_dtensor as _is_dtensor

__all__ = ["rmsnorm_local", "flash_attention_local", "ssd_scan_local",
           "embedding_local", "along"]


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: ``to_local``'s
    backward declares the forward DTensor's (contiguous) strides for the
    local gradient, which a plain version's autograd may not give."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local(t, mesh, placements, grad_placements=None):
    """``t`` laid out by ``placements``, as this rank's local tensor."""
    loc = t.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements)
    return _ContiguousGrad.apply(loc)


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _keep(placements, dims):
    """Keep ``Shard(d)`` for d in ``dims``; replicate everything else."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in placements]


def _wrap(local, mesh, placements, like_shape):
    """The local result as a DTensor of ``like_shape``, declared contiguous
    (so made so: DTensor plans later views from the declared strides)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False,
                              shape=torch.Size(like_shape),
                              stride=_contiguous_stride(like_shape))


def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def rmsnorm_local(x, scale, eps: float):
    from torch.distributed.tensor import Partial, Replicate, Shard

    from .rmsnorm import rmsnorm
    mesh = x.device_mesh
    px = _keep(x.placements, range(x.ndim - 1))
    xl = _local(x, mesh, px)
    sgrad = [Partial() if isinstance(p, Shard) else Replicate() for p in px]
    sl = _local(_as_dtensor(scale, mesh), mesh, [Replicate()] * mesh.ndim,
                sgrad)
    return _wrap(rmsnorm(xl.contiguous(), sl, eps), mesh, px, x.shape)


def flash_attention_local(q, k, v, *, causal: bool, window: int,
                          softcap: float, heads_dim: int = 1):
    """q (B, H, S, D), k and v (B, KV, S, D) DTensors → (B, H, S, D); with
    ``heads_dim`` 2, all in the model's (B, S, H, D) layout → (B, S, H, D).
    Those are transposed and made contiguous as DTensors, as the unsharded
    model does, so a one-GPU mesh hands the kernel the same layouts."""
    from torch.distributed.tensor import Replicate, Shard

    from .flash_attention import flash_attention
    mesh = q.device_mesh
    k, v = _as_dtensor(k, mesh), _as_dtensor(v, mesh)
    hd = Shard(heads_dim)
    h, kvh = q.shape[heads_dim], k.shape[heads_dim]
    pq = _keep(q.placements, (0, heads_dim))
    head_dims = [i for i, p in enumerate(pq) if p == hd]
    # heads sharded over more than one mesh dim, or over one that splits a
    # query group (or divides the heads unevenly): gather them
    if len(head_dims) > 1 or any(h % mesh.size(i) or kvh % mesh.size(i)
                                 for i in head_dims):
        pq = [Replicate() if p == hd else p for p in pq]
    swap = (lambda t: t.transpose(1, heads_dim)) if heads_dim != 1 \
        else (lambda t: t)
    pq1 = [Shard(1) if p == hd else p for p in pq]
    ql, kl, vl = (_local(swap(t.redistribute(mesh, pq)).contiguous(), mesh,
                         pq1) for t in (q, k, v))
    out = flash_attention(ql, kl, vl,
                          causal=causal, window=window, softcap=softcap)
    shape = q.shape if heads_dim == 1 else swap(q).shape
    return swap(_wrap(out, mesh, pq1, shape))


def ssd_scan_local(chunk_decay, dbx):
    from torch.distributed.tensor import Shard

    from .ssd_scan import ssd_scan
    mesh = dbx.device_mesh
    pd = _keep(dbx.placements, (0, 2))
    dec = _local(_as_dtensor(chunk_decay, mesh), mesh, pd)
    xl = _local(dbx, mesh, pd)
    before, final = ssd_scan(dec.contiguous(), xl.contiguous())
    pf = [Shard(1) if p == Shard(2) else p for p in pd]
    b, c, hh, p, n = dbx.shape
    return (_wrap(before, mesh, pd, dbx.shape),
            _wrap(final, mesh, pf, (b, hh, p, n)))


def embedding_local(table, idx):
    """Rows of a (V, d) DTensor ``table`` at integer ``idx`` (a DTensor, or
    a plain tensor the same on every rank) → a (*idx.shape, d) DTensor laid
    out as ``idx``.  The table's gradient is each rank's partial sum over
    the mesh dims that split ``idx``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    idx = _as_dtensor(idx, mesh)
    pi = [p if isinstance(p, Shard) else Replicate() for p in idx.placements]
    il = idx.redistribute(mesh, pi).to_local()
    tgrad = [Partial() if isinstance(p, Shard) else Replicate() for p in pi]
    tl = _local(table, mesh, [Replicate()] * mesh.ndim, tgrad)
    return _wrap(tl[il], mesh, pi, (*idx.shape, table.shape[-1]))


def along(fn, x, dim: int):
    """``fn`` of a shape-keeping op along ``dim`` (``cumsum``, ``roll``): on
    a DTensor ``x``, run on the local tensor with ``dim`` gathered and the
    other dims' shards kept; on a plain tensor, run as it is."""
    if not _is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    d = dim % x.ndim
    pl = [p if isinstance(p, Shard) and p.dim != d else Replicate()
          for p in x.placements]
    return _wrap(fn(_local(x, mesh, pl)), mesh, pl, x.shape)
