"""SSD inter-chunk state scan — the sequential part of Mamba-2 prefill.

Port of ``repro/kernels/ssd_scan.py``: ``h_c = h_{c−1}·decay_c + dbx_c``
from ``h_0 = 0``, returning the state entering every chunk and the final
state.  ``models/ssm.py::ssd_forward`` computes every chunk's ``dbx`` and
decay at once and takes the states entering the chunks from one launch.

``ssd_scan`` runs CUDA tensors through ``SSDScanFn``, whose forward
launches the CUDA kernel ``csrc/ssd_scan.cu`` and whose backward launches
that source's reverse scan (``ssd_scan_backward``); CPU tensors run the
plain PyTorch version ``ssd_scan_ref`` (the port of
``repro/kernels/ref.py::ssd_scan_ref``), which autograd differentiates.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _work

__all__ = ["ssd_scan", "ssd_scan_ref", "ssd_scan_backward", "SSDScanFn",
           "ssd_scan_bwd_plan", "ssd_scan_work"]

#: threads of a backward block (``kBwdThreads`` in ``csrc/ssd_scan.cu``)
BWD_THREADS = 512
#: state elements a backward thread holds (the kernel's instances)
BWD_PER_THREAD = (1, 2, 4, 8, 16, 32)


def ssd_scan_ref(chunk_decay: torch.Tensor, dbx: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: chunk_decay (B, C, H), dbx (B, C, H, P, N) →
    (h_before (B, C, H, P, N), h_final (B, H, P, N)), both f32."""
    b, c, hh, p, n = dbx.shape
    dec = chunk_decay.to(torch.float32)
    contrib = dbx.to(torch.float32)
    h = torch.zeros(b, hh, p, n, dtype=torch.float32, device=dbx.device)
    before = torch.empty(b, c, hh, p, n, dtype=torch.float32,
                         device=dbx.device)
    for i in range(c):
        before[:, i] = h
        h = h * dec[:, i, :, None, None] + contrib[:, i]
    return before, h


def ssd_scan_bwd_plan(pn: int) -> int:
    """State elements a backward thread holds for P·N = ``pn``: the fewest
    of ``BWD_PER_THREAD`` that ``BWD_THREADS`` threads cover ``pn`` with."""
    per = next((c for c in BWD_PER_THREAD if c * BWD_THREADS >= pn), None)
    if per is None:
        raise ValueError(f"ssd_scan backward: P·N = {pn} exceeds the "
                         f"kernel's {BWD_PER_THREAD[-1] * BWD_THREADS}")
    return per


def _lib(backward: bool = False):
    from ._build import library
    lib = library("ssd_scan")
    fn = lib.ssd_scan_bwd_f32 if backward else lib.ssd_scan_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       if backward else
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4) \
            + [ctypes.c_void_p]
    return fn


def _check(chunk_decay: torch.Tensor, dbx: torch.Tensor) -> None:
    if dbx.device.type != "cuda":
        raise ValueError(f"ssd_scan takes CPU or CUDA tensors; got "
                         f"{dbx.device}")
    if dbx.ndim != 5 or dbx.dtype != torch.float32 \
            or not dbx.is_contiguous():
        raise ValueError(f"ssd_scan: dbx must be a contiguous (B, C, H, P, "
                         f"N) float32 tensor; got {dbx.dtype} "
                         f"{tuple(dbx.shape)}")
    b, c, hh, p, n = dbx.shape
    if chunk_decay.device != dbx.device \
            or chunk_decay.dtype != torch.float32 \
            or tuple(chunk_decay.shape) != (b, c, hh) \
            or not chunk_decay.is_contiguous():
        raise ValueError(f"ssd_scan: chunk_decay must be a contiguous "
                         f"float32 tensor of shape {(b, c, hh)} on "
                         f"{dbx.device}; got {chunk_decay.dtype} "
                         f"{tuple(chunk_decay.shape)} on "
                         f"{chunk_decay.device}")
    if hh > 65535 or b > 65535:
        raise ValueError(f"ssd_scan: B={b} and H={hh} must each be at most "
                         f"65535 (the kernel's grid)")


def _forward(chunk_decay: torch.Tensor, dbx: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, c, hh, p, n = dbx.shape
    before = torch.empty_like(dbx)
    final = torch.empty(b, hh, p, n, dtype=torch.float32, device=dbx.device)
    if final.numel() == 0:
        return before, final
    err = _lib()(chunk_decay.data_ptr(), dbx.data_ptr(), before.data_ptr(),
                 final.data_ptr(), b, c, hh, p * n,
                 torch.cuda.current_stream(dbx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return before, final


def ssd_scan_backward(chunk_decay: torch.Tensor, before: torch.Tensor,
                      g_before: torch.Tensor, g_final: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reverse-scan kernel on CUDA tensors: the forward's decay and
    h_before and the gradients of its two outputs (contiguous f32) →
    (d_decay (B, C, H), d_dbx (B, C, H, P, N))."""
    _check(chunk_decay, before)
    b, c, hh, p, n = before.shape
    for name, t, shape in (("g_before", g_before, before.shape),
                           ("g_final", g_final, (b, hh, p, n))):
        if t.device != before.device or t.dtype != torch.float32 \
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"ssd_scan backward: {name} must be a "
                             f"contiguous float32 tensor of shape "
                             f"{tuple(shape)}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    d_dbx = torch.empty_like(before)
    d_decay = torch.empty_like(chunk_decay)
    if d_dbx.numel() == 0:
        return d_decay.zero_(), d_dbx
    err = _lib(True)(chunk_decay.data_ptr(), before.data_ptr(),
                     g_before.data_ptr(), g_final.data_ptr(),
                     d_dbx.data_ptr(), d_decay.data_ptr(), b, c, hh, p * n,
                     ssd_scan_bwd_plan(p * n),
                     torch.cuda.current_stream(before.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    ssd_scan_backward.launches += 1
    ssd_scan_backward.route_launches["reverse_scan"] += 1
    return d_decay, d_dbx


ssd_scan_backward.launches = 0
#: backward launches per route (one: the reverse scan)
ssd_scan_backward.route_launches = {"reverse_scan": 0}


class SSDScanFn(torch.autograd.Function):
    """The scan kernel with the reverse-scan kernel as its gradient (saves
    the decay and the forward's h_before)."""

    @staticmethod
    def forward(ctx, chunk_decay, dbx):
        before, final = _forward(chunk_decay, dbx)
        ctx.save_for_backward(chunk_decay, before)
        return before, final

    @staticmethod
    def backward(ctx, g_before, g_final):
        chunk_decay, before = ctx.saved_tensors
        return ssd_scan_backward(chunk_decay, before, g_before.contiguous(),
                                 g_final.contiguous())


def ssd_scan_work(b: int, c: int, h: int, p: int, n: int,
                  backward: bool = False):
    """(operations, bytes) of one launch at dbx (B, C, H, P, N), all f32:
    the forward reads the decay and dbx and writes h_before and h_final (2
    operations a state element a chunk); the backward reads the decay,
    h_before and both outputs' gradients and writes d_dbx and d_decay (4)."""
    state = b * c * h * p * n
    if backward:
        return 4 * state, 4 * (3 * state + b * h * p * n + 2 * b * c * h)
    return 2 * state, 4 * (b * c * h + 2 * state + b * h * p * n)


def _counted(chunk_decay: torch.Tensor, dbx: torch.Tensor):
    """The shape-only / counted route (``kernels/_work.py``)."""
    from ._work import KernelSpec, counted_call
    b, c, hh, p, n = dbx.shape
    spec = KernelSpec(
        "ssd_scan", ssd_scan_ref,
        [(tuple(dbx.shape), torch.float32), ((b, hh, p, n), torch.float32)],
        [], lambda bwd: ssd_scan_work(b, c, hh, p, n, bwd),
        saves=(0, 2))     # the decay and h_before, as SSDScanFn
    return counted_call(spec, chunk_decay, dbx)


def ssd_scan(chunk_decay: torch.Tensor, dbx: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """chunk_decay (B, C, H) f32, dbx (B, C, H, P, N) f32, both contiguous
    → (h_before (B, C, H, P, N), h_final (B, H, P, N)), f32.

    CUDA tensors go through ``SSDScanFn`` (``csrc/ssd_scan.cu``'s scan and,
    for the gradient, its reverse scan); CPU tensors take ``ssd_scan_ref``.
    A DTensor scans each rank's (batch, head) slice on its local tensors
    (``kernels/_dtensor.py``); a fake tensor, and a meta or CPU tensor
    while the work counter is active, take the counting routes of
    ``kernels/_work.py``.
    """
    if type(dbx) is not torch.Tensor or _work.COUNTER.active:
        if _work.is_dtensor(dbx):
            from ._dtensor import ssd_scan_local
            return ssd_scan_local(chunk_decay, dbx)
        if _work.is_shape_only(dbx) or (_work.COUNTER.active
                                        and dbx.device.type == "cpu"):
            return _counted(chunk_decay, dbx)
    if dbx.device.type == "cpu":
        return ssd_scan_ref(chunk_decay, dbx)
    _check(chunk_decay, dbx)
    return SSDScanFn.apply(chunk_decay, dbx)


ssd_scan.launches = 0
