"""RMSNorm kernel — every norm of the LM path.

Port of ``repro/kernels/rmsnorm.py``.  Per row of ``x`` (..., d):
``x · rsqrt(mean(x²) + eps) · scale`` with f32 arithmetic and the output in
``x``'s dtype (f32 or bf16).

``rmsnorm`` launches the CUDA kernel ``csrc/rmsnorm.cu`` on CUDA tensors and
runs the plain PyTorch version ``rmsnorm_ref`` (the port of
``repro/kernels/ref.py::rmsnorm_ref``) on CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["rmsnorm", "rmsnorm_ref"]


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: x (..., d), scale (d,) → x's shape and dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)


_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}


def _lib(dtype: torch.dtype):
    from ._build import library
    fn = getattr(library("rmsnorm"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_float, ctypes.c_void_p]
    return fn


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d) contiguous f32 or bf16, scale (d,) f32 → x's shape/dtype.

    CUDA tensors launch ``csrc/rmsnorm.cu``; CPU tensors take
    ``rmsnorm_ref``.
    """
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm takes CPU or CUDA tensors; got "
                         f"{x.device}")
    if x.dtype not in _ENTRY or x.ndim < 1 or not x.is_contiguous():
        raise ValueError(f"rmsnorm: x must be a contiguous float32 or "
                         f"bfloat16 tensor; got {x.dtype} {tuple(x.shape)}")
    d = x.shape[-1]
    if scale.device != x.device or scale.dtype != torch.float32 \
            or tuple(scale.shape) != (d,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be a contiguous float32 "
                         f"tensor of shape ({d},) on {x.device}; got "
                         f"{scale.dtype} {tuple(scale.shape)} on "
                         f"{scale.device}")
    rows = x.numel() // d if d else 0
    if rows >= 2 ** 31:
        raise ValueError(f"rmsnorm: {rows} rows exceed the kernel's int32 "
                         f"row count")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    err = _lib(x.dtype)(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        rows, d, eps,
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
