"""Flash attention kernel — the LM's prefill self-attention.

Port of ``repro/kernels/flash_attention.py``: online-softmax attention with
GQA head grouping (head h reads KV head h // (H / KV)), a causal mask and an
optional sliding window, f32 arithmetic and the output in q's dtype.

``flash_attention`` launches the CUDA kernel ``csrc/flash_attention.cu`` on
CUDA tensors and runs the plain PyTorch version ``flash_attention_ref`` (the
port of ``repro/kernels/ref.py::flash_attention_ref``) on CPU tensors.  Both
apply ``window`` only under ``causal``, as ``ref.py`` does.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention", "flash_attention_ref", "HEAD_DIMS"]

#: head dims the CUDA kernel is compiled for
HEAD_DIMS = (64, 80, 128)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Plain PyTorch version: q (B, H, S, D), k/v (B, KV, S, D) → (B, H, S, D)
    in q's dtype; f32 softmax."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    g = h // kv
    qg = q.reshape(b, kv, g, s, d).to(torch.float32)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(torch.float32)) \
        / math.sqrt(d)
    if causal:
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        mask = j <= i
        if window:
            mask &= j > i - window
        scores = torch.where(mask, scores, torch.tensor(-1e30,
                                                        device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.to(torch.float32))
    return out.reshape(b, h, s, d).to(q.dtype)


_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def _lib(dtype: torch.dtype):
    from ._build import library
    fn = getattr(library("flash_attention"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, KV, S, D), contiguous, all f32 or all bf16 →
    (B, H, S, D) in q's dtype.

    CUDA tensors launch ``csrc/flash_attention.cu`` (D in ``HEAD_DIMS``);
    CPU tensors take ``flash_attention_ref``.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors; got "
                         f"{q.device}")
    if q.ndim != 4 or q.dtype not in _ENTRY or not q.is_contiguous():
        raise ValueError(f"flash_attention: q must be a contiguous (B, H, S, "
                         f"D) float32 or bfloat16 tensor; got {q.dtype} "
                         f"{tuple(q.shape)}")
    b, h, s, d = q.shape
    kv = k.shape[1] if k.ndim == 4 else 0
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype \
                or tuple(t.shape) != (b, kv, s, d) or not t.is_contiguous():
            raise ValueError(
                f"flash_attention: {name} must be a contiguous {q.dtype} "
                f"tensor of shape {(b, kv, s, d)} on {q.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads do not group "
                         f"over {kv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one the "
                         f"kernel is built for {HEAD_DIMS}")
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: B={b} and H={h} must each be at "
                         f"most 65535 (the kernel's grid)")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0; got "
                         f"{window}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, h, kv, s, d, 1.0 / math.sqrt(d),
                        int(causal), int(window),
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
