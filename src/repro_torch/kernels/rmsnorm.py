"""RMSNorm kernel — every norm of the LM path.

Port of ``repro/kernels/rmsnorm.py``.  Per row of ``x`` (..., d):
``x · rsqrt(mean(x²) + eps) · scale`` with f32 arithmetic and the output in
``x``'s dtype (f32 or bf16).

``rmsnorm`` launches the CUDA kernel ``csrc/rmsnorm.cu`` on CUDA tensors and
runs the plain PyTorch version ``rmsnorm_ref`` (the port of
``repro/kernels/ref.py::rmsnorm_ref``) on CPU tensors.  The kernel has three
routes; ``rmsnorm_launch_plan`` picks one per call and is the mirror of the
launch (its grid, block and the vectors each thread holds).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

__all__ = ["rmsnorm", "rmsnorm_ref", "rmsnorm_launch_plan", "RmsnormPlan",
           "ROUTES", "FEW_ROWS"]

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


@functools.cache
def _lib(dtype: torch.dtype):
    from ._build import library
    fn = getattr(library("rmsnorm"), _ENTRY[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d) contiguous f32 or bf16, scale (d,) f32 → x's shape/dtype.

    CUDA tensors launch ``csrc/rmsnorm.cu`` on the route
    ``rmsnorm_launch_plan`` gives; CPU tensors take ``rmsnorm_ref``.
    """
    if x.is_cpu:
        return rmsnorm_ref(x, scale, eps)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm takes CPU or CUDA tensors; got "
                         f"{x.device}")
    if x.dtype not in _ENTRY or x.ndim < 1 or not x.is_contiguous():
        raise ValueError(f"rmsnorm: x must be a contiguous float32 or "
                         f"bfloat16 tensor; got {x.dtype} {tuple(x.shape)}")
    d = x.shape[-1]
    dev = x.get_device()
    if not scale.is_cuda or scale.get_device() != dev \
            or scale.dtype != torch.float32 or scale.shape != (d,) \
            or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be a contiguous float32 "
                         f"tensor of shape ({d},) on {x.device}; got "
                         f"{scale.dtype} {tuple(scale.shape)} on "
                         f"{scale.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"rmsnorm: {rows} rows exceed the kernel's int32 "
                         f"row count")
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


rmsnorm.launches = 0
#: launches per route of ``rmsnorm_launch_plan``
rmsnorm.route_launches = dict.fromkeys(ROUTES, 0)
