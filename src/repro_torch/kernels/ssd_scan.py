"""SSD inter-chunk state scan — the sequential part of Mamba-2 prefill.

Port of ``repro/kernels/ssd_scan.py``: ``h_c = h_{c−1}·decay_c + dbx_c``
from ``h_0 = 0``, returning the state entering every chunk and the final
state.  ``models/ssm.py::ssd_forward`` computes every chunk's ``dbx`` and
decay at once and takes the states entering the chunks from one launch.

``ssd_scan`` launches the CUDA kernel ``csrc/ssd_scan.cu`` on CUDA tensors
and runs the plain PyTorch version ``ssd_scan_ref`` (the port of
``repro/kernels/ref.py::ssd_scan_ref``) on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

__all__ = ["ssd_scan", "ssd_scan_ref"]


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


def _lib():
    from ._build import library
    fn = library("ssd_scan").ssd_scan_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    return fn


def ssd_scan(chunk_decay: torch.Tensor, dbx: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """chunk_decay (B, C, H) f32, dbx (B, C, H, P, N) f32, both contiguous
    → (h_before (B, C, H, P, N), h_final (B, H, P, N)), f32.

    CUDA tensors launch ``csrc/ssd_scan.cu``; CPU tensors take
    ``ssd_scan_ref``.
    """
    if dbx.device.type == "cpu":
        return ssd_scan_ref(chunk_decay, dbx)
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
    before = torch.empty_like(dbx)
    final = torch.empty(b, hh, p, n, dtype=torch.float32, device=dbx.device)
    if final.numel() == 0:
        return before, final
    if hh > 65535 or b > 65535:
        raise ValueError(f"ssd_scan: B={b} and H={hh} must each be at most "
                         f"65535 (the kernel's grid)")
    err = _lib()(chunk_decay.data_ptr(), dbx.data_ptr(), before.data_ptr(),
                 final.data_ptr(), b, c, hh, p * n,
                 torch.cuda.current_stream(dbx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return before, final


ssd_scan.launches = 0
