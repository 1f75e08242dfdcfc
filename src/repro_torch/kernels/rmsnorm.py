"""RMSNorm kernel — every norm of the LM path.

Port of ``repro/kernels/rmsnorm.py``.  Per row of ``x`` (..., d):
``x · rsqrt(mean(x²) + eps) · scale`` with f32 arithmetic and the output in
``x``'s dtype (f32 or bf16).

``rmsnorm`` runs CUDA tensors through ``RMSNormFn``, whose forward launches
the CUDA kernel ``csrc/rmsnorm.cu`` and whose backward launches the
backward kernel of the same source (``rmsnorm_backward``: dx in x's dtype,
dscale in f32); CPU tensors run the plain PyTorch version ``rmsnorm_ref``
(the port of ``repro/kernels/ref.py::rmsnorm_ref``), which autograd
differentiates.  The forward kernel has three routes;
``rmsnorm_launch_plan`` picks one per call and is the mirror of the launch
(its grid, block and the vectors each thread holds).  ``rmsnorm_bwd_plan``
is the backward's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _work

__all__ = ["rmsnorm", "rmsnorm_ref", "rmsnorm_work", "rmsnorm_launch_plan",
           "RmsnormPlan",
           "ROUTES", "FEW_ROWS", "RMSNormFn", "rmsnorm_backward",
           "rmsnorm_bwd_plan", "RmsnormBwdPlan"]

#: route names, in the order of the kernel's ``Route`` enum
ROUTES = ("warp_vec", "block_vec", "general")
#: calls of at most this many rows take ``block_vec``: the warp route would
#: launch fewer blocks (8 rows each) than the H100 has SMs (132 · 8 = 1056)
FEW_ROWS = 1024
#: 16-byte vectors a lane holds on ``warp_vec`` (the kernel's instances)
WARP_COUNTS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20)
#: 16-byte vectors a thread holds on ``block_vec``
BLOCK_COUNTS = (1, 2, 4, 8)
#: rows (warps) a ``warp_vec`` block
WARP_ROWS = 8
#: most threads a ``block_vec`` or ``general`` block takes
MAX_BLOCK_THREADS = 512
#: threads of a ``general`` block at most
GENERAL_THREADS = 256
#: threads of a backward block (``kBwdThreads``)
BWD_THREADS = 256
#: columns a backward thread holds in registers (the kernel's instances)
BWD_PER_THREAD = (1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 32)
#: backward blocks aimed at: four per SM of the H100's 132
BWD_TARGET_BLOCKS = 4 * 132
#: threads of a block of the dscale reduction (``kBwdReduceThreads``)
BWD_REDUCE_THREADS = 128


class RmsnormPlan(NamedTuple):
    """One launch of ``csrc/rmsnorm.cu``.

    ``vec`` elements per load (8 bf16 or 4 f32 in a 16-byte vector; 1 on
    the scalar ``general`` route); ``per_thread`` vectors a thread holds in
    registers (on ``general``, the elements a thread walks per pass);
    ``threads`` a block; ``rows_per_block``; ``blocks`` in the grid.
    """

    route: str
    vec: int
    per_thread: int
    threads: int
    rows_per_block: int
    blocks: int


def _round_warp(n: int) -> int:
    return -(-n // 32) * 32


@functools.lru_cache(maxsize=256)
def rmsnorm_launch_plan(rows: int, d: int, dtype: torch.dtype,
                        aligned: bool = True) -> RmsnormPlan:
    """The launch ``rmsnorm`` makes for ``rows`` rows of width ``d``.

    ``aligned``: x and scale start on 16-byte boundaries (the output is a
    fresh allocation and always does).  The vector routes need that and
    ``d`` a multiple of the vector width, so every row starts on a vector.

    - ``warp_vec`` for more than ``FEW_ROWS`` rows: a warp per row, 8 rows a
      block; a lane holds the fewest of ``WARP_COUNTS`` vectors that cover
      the row, at most 20 (bf16 rows up to 5120, f32 up to 2560).
    - ``block_vec`` for at most ``FEW_ROWS`` rows, or a row too wide for a
      warp: a block per row; a thread holds the fewest of ``BLOCK_COUNTS``
      vectors that let at most 512 threads cover the row.
    - ``general`` otherwise (a ragged ``d``, an unaligned pointer, or a row
      wider than 512 threads of 8 vectors): a block per row of up to 256
      threads striding over the row with scalar loads.
    """
    vec = 16 // dtype.itemsize
    nvec = d // vec
    if aligned and d % vec == 0 and d > 0:
        if rows > FEW_ROWS:
            n = next((c for c in WARP_COUNTS if 32 * c >= nvec), None)
            if n is not None:
                return RmsnormPlan("warp_vec", vec, n, 32 * WARP_ROWS,
                                   WARP_ROWS, -(-rows // WARP_ROWS))
        n = next((c for c in BLOCK_COUNTS
                  if c * MAX_BLOCK_THREADS >= nvec), None)
        if n is not None:
            return RmsnormPlan("block_vec", vec, n,
                               _round_warp(-(-nvec // n)), 1, rows)
    threads = min(GENERAL_THREADS, _round_warp(max(d, 1)))
    return RmsnormPlan("general", 1, -(-d // threads), threads, 1, rows)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: x (..., d), scale (d,) → x's shape and dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)


_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_BWD_ENTRY = {torch.float32: "rmsnorm_bwd_f32",
              torch.bfloat16: "rmsnorm_bwd_bf16"}
#: the backward's route per dtype
BWD_ROUTES = {torch.float32: "rows_f32", torch.bfloat16: "rows_bf16"}


class RmsnormBwdPlan(NamedTuple):
    """One backward launch: ``per_thread`` columns a thread of
    ``BWD_THREADS`` holds, ``rows_per_block`` consecutive rows a block,
    ``blocks`` in the grid (and rows of the dscale partials)."""

    per_thread: int
    rows_per_block: int
    blocks: int


@functools.lru_cache(maxsize=256)
def rmsnorm_bwd_plan(rows: int, d: int) -> RmsnormBwdPlan:
    """The backward launch for ``rows`` rows of width ``d``: the fewest of
    ``BWD_PER_THREAD`` columns a thread that cover the row, and runs of rows
    that make about ``BWD_TARGET_BLOCKS`` blocks."""
    per = next((c for c in BWD_PER_THREAD if c * BWD_THREADS >= d), None)
    if per is None or d < 1:
        raise ValueError(f"rmsnorm backward: width {d} is not one the "
                         f"kernel is built for (1..{BWD_PER_THREAD[-1] * BWD_THREADS})")
    rpb = max(1, -(-rows // BWD_TARGET_BLOCKS))
    return RmsnormBwdPlan(per, rpb, -(-rows // rpb))


@functools.cache
def _lib(dtype: torch.dtype, backward: bool = False):
    from ._build import library
    fn = getattr(library("rmsnorm"), (_BWD_ENTRY if backward
                                      else _ENTRY)[dtype])
    fn.restype = ctypes.c_int
    if backward:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _check(x: torch.Tensor, scale: torch.Tensor) -> int:
    """Raise on what the kernels do not take; → d."""
    if not x.is_cuda:
        raise ValueError(f"rmsnorm takes CPU or CUDA tensors; got "
                         f"{x.device}")
    if x.dtype not in _ENTRY or x.ndim < 1 or not x.is_contiguous():
        raise ValueError(f"rmsnorm: x must be a contiguous float32 or "
                         f"bfloat16 tensor; got {x.dtype} {tuple(x.shape)}")
    d = x.shape[-1]
    if not scale.is_cuda or scale.get_device() != x.get_device() \
            or scale.dtype != torch.float32 or scale.shape != (d,) \
            or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be a contiguous float32 "
                         f"tensor of shape ({d},) on {x.device}; got "
                         f"{scale.dtype} {tuple(scale.shape)} on "
                         f"{scale.device}")
    if x.numel() // max(d, 1) >= 2 ** 31:
        raise ValueError(f"rmsnorm: {x.numel() // d} rows exceed the "
                         f"kernel's int32 row count")
    return d


def _forward(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """One launch of the forward kernel on the plan's route."""
    d = _check(x, scale)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rows = x.numel() // d
    dev = x.get_device()
    xp, sp = x.data_ptr(), scale.data_ptr()
    plan = rmsnorm_launch_plan(rows, d, x.dtype, (xp | sp) % 16 == 0)
    err = _lib(x.dtype)(xp, sp, out.data_ptr(), rows, d, eps,
                        ROUTES.index(plan.route), plan.per_thread,
                        plan.threads, plan.blocks,
                        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed ({plan.route}): "
                           f"CUDA error {err}")
    rmsnorm.launches += 1
    rmsnorm.route_launches[plan.route] += 1
    return out


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6):
    """The backward kernel on CUDA tensors: x (..., d) and the output
    gradient g (x's shape and dtype), both contiguous → (dx in x's dtype,
    dscale (d,) float32)."""
    d = _check(x, scale)
    if g.device != x.device or g.dtype != x.dtype or g.shape != x.shape \
            or not g.is_contiguous():
        raise ValueError(f"rmsnorm backward: g must be a contiguous "
                         f"{x.dtype} tensor of shape {tuple(x.shape)} on "
                         f"{x.device}; got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    dx = torch.empty_like(x)
    dscale = torch.zeros(d, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, dscale
    rows = x.numel() // d
    plan = rmsnorm_bwd_plan(rows, d)
    partial = torch.empty(plan.blocks, d, dtype=torch.float32,
                          device=x.device)
    err = _lib(x.dtype, True)(
        x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dscale.data_ptr(), rows, d, eps,
        plan.per_thread, plan.rows_per_block, plan.blocks,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed: CUDA "
                           f"error {err}")
    rmsnorm_backward.launches += 1
    rmsnorm_backward.route_launches[BWD_ROUTES[x.dtype]] += 1
    return dx, dscale


rmsnorm_backward.launches = 0
#: backward launches per route (one kernel pair per dtype)
rmsnorm_backward.route_launches = dict.fromkeys(BWD_ROUTES.values(), 0)


class RMSNormFn(torch.autograd.Function):
    """The kernel's forward with the backward kernel as its gradient
    (saves x and scale)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, g.contiguous(), ctx.eps)
        return dx, dscale, None


def rmsnorm_work(rows: int, d: int, dtype: torch.dtype,
                 backward: bool = False):
    """(operations, bytes) of one launch on ``rows`` rows of width ``d`` in
    ``dtype``: the forward reads x and the f32 scale and writes the output
    (4 operations an element); the backward reads x, the output's gradient
    and the scale and writes dx and the f32 dscale (8 an element)."""
    n, esize = rows * d, dtype.itemsize
    if backward:
        return 8 * n, 3 * n * esize + 8 * d
    return 4 * n, 2 * n * esize + 4 * d


def _counted(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """The shape-only / counted route (``kernels/_work.py``)."""
    from ._work import KernelSpec, counted_call
    d = x.shape[-1]
    rows = x.numel() // max(d, 1)
    dtype = x.dtype      # not x in the closure (see flash_attention's)
    spec = KernelSpec(
        "rmsnorm", lambda a, w: rmsnorm_ref(a, w, eps),
        [(tuple(x.shape), dtype)], [],
        lambda bwd: rmsnorm_work(rows, d, dtype, bwd),
        saves=(0, 1))     # x and scale, as RMSNormFn
    return counted_call(spec, x, scale)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d) contiguous f32 or bf16, scale (d,) f32 → x's shape/dtype.

    CUDA tensors go through ``RMSNormFn`` (the forward kernel on the route
    ``rmsnorm_launch_plan`` gives, the backward kernel for the gradient);
    CPU tensors take ``rmsnorm_ref``.  A DTensor runs each rank's rows on
    its local tensors (``kernels/_dtensor.py``); a fake tensor, and a meta
    or CPU tensor while the work counter is active, take the counting
    routes of ``kernels/_work.py``.
    """
    if type(x) is not torch.Tensor or _work.COUNTER.active:
        if _work.is_dtensor(x):
            from ._dtensor import rmsnorm_local
            return rmsnorm_local(x, scale, eps)
        if _work.is_shape_only(x) or (_work.COUNTER.active and x.is_cpu):
            return _counted(x, scale, eps)
    if x.is_cpu:
        return rmsnorm_ref(x, scale, eps)
    _check(x, scale)
    return RMSNormFn.apply(x, scale, eps)


rmsnorm.launches = 0
#: launches per route of ``rmsnorm_launch_plan``
rmsnorm.route_launches = dict.fromkeys(ROUTES, 0)
