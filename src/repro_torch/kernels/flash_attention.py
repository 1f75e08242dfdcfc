"""Flash attention kernel — the LM's prefill self-attention.

Port of ``repro/kernels/flash_attention.py``: online-softmax attention with
GQA head grouping (head h reads KV head h // (H / KV)), a causal mask and an
optional sliding window, f32 softmax statistics and accumulation, and the
output in q's dtype.

``flash_attention`` runs CUDA tensors through ``FlashAttentionFn``.  Its
forward launches a kernel chosen by dtype: bf16 runs
``csrc/flash_attention_sm90.cu`` (``wgmma`` on the tensor cores, fed by TMA)
and f32 runs the SIMT kernel of ``csrc/flash_attention.cu`` (exact to 1e-5,
which TF32 tensor cores could not be).  Its backward
(``flash_attention_backward``) launches ``csrc/flash_attention_bwd.cu``'s
two kernels, templated on the dtype (dq, then dk and dv), from the saved q,
k, v and output.  CPU tensors run the plain PyTorch version
``flash_attention_ref`` (the port of
``repro/kernels/ref.py::flash_attention_ref``), which autograd
differentiates.  All apply ``window`` only under ``causal``, as ``ref.py``
does.

``flash_tile_plan`` is the Python mirror of the forward kernels' loop
bounds: which key tiles each query tile visits and which of them apply the
in-tile mask; ``flash_bwd_tile_plan`` is the backward dk/dv kernel's: which
query tiles each key tile is visited by, and which of them mask.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_ref", "flash_mask",
           "flash_tile_plan", "flash_pairs", "TileVisit", "HEAD_DIMS",
           "BLOCK_Q", "BLOCK_K", "FlashAttentionFn",
           "flash_attention_backward", "flash_bwd_tile_plan",
           "BWD_BLOCK_Q", "BWD_BLOCK_K"]

#: head dims the CUDA kernels are compiled for
HEAD_DIMS = (64, 80, 96, 128)
#: query rows and keys per tile of the bf16 kernel (kBQ, kBK in
#: ``csrc/flash_attention_sm90.cu``)
BLOCK_Q = 128
BLOCK_K = 128
#: query rows and keys per tile of the backward kernels (kBQ, kBK in
#: ``csrc/flash_attention_bwd.cu``)
BWD_BLOCK_Q = 64
BWD_BLOCK_K = 64


def flash_mask(s: int, causal: bool, window: int,
               device=None) -> Optional[torch.Tensor]:
    """The (S, S) bool mask of ``flash_attention_ref`` (True = attend), or
    None when nothing is masked (``causal=False``: no window either)."""
    if not causal:
        return None
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    return mask


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
    mask = flash_mask(s, causal, window, q.device)
    if mask is not None:
        scores = torch.where(mask, scores, torch.tensor(-1e30,
                                                        device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.to(torch.float32))
    return out.reshape(b, h, s, d).to(q.dtype)


class TileVisit(NamedTuple):
    """The key tiles one query tile visits: ``lo``..``hi`` inclusive, and
    those among them that apply the in-tile mask."""
    lo: int
    hi: int
    masked: Tuple[int, ...]


def flash_tile_plan(s: int, block_q: int, block_k: int, causal: bool,
                    window: int) -> List[TileVisit]:
    """Per query tile (rows q0 = n·block_q ...), the key tiles the bf16
    kernel visits and masks — the same integer arithmetic as its loop.

    Under causal masking a query tile visits no key tile above its last row
    and, with a window, none wholly older than its first row's window.  A
    visited tile applies the mask when it holds keys at or past S, keys
    after the tile's first row (the diagonal), or keys at or before its last
    row's window edge; every other visited tile is wholly unmasked.
    """
    n_kt = -(-s // block_k)
    plan = []
    for q0 in range(0, s, block_q):
        lo, hi = 0, n_kt - 1
        if causal:
            hi = min(hi, (q0 + block_q - 1) // block_k)
            if window > 0:
                lo = max(0, q0 - window + 1) // block_k
        masked = tuple(
            kt for kt in range(lo, hi + 1)
            if (kt + 1) * block_k > s
            or (causal and ((kt + 1) * block_k - 1 > q0
                            or (window > 0
                                and kt * block_k <= q0 + block_q - 1
                                - window))))
        plan.append(TileVisit(lo, hi, masked))
    return plan


def flash_bwd_tile_plan(s: int, block_q: int, block_k: int, causal: bool,
                        window: int) -> List[TileVisit]:
    """Per key tile (keys k0 = n·block_k ...), the query tiles the backward
    dk/dv kernel visits (``lo``..``hi``) and those among them that apply the
    mask — the same integer arithmetic as its loop.

    Under causal masking no query before a key sees it, so a key tile is
    visited by no query tile before the one holding k0, and, with a window,
    by none wholly past its last key's window (query k0 + block_k − 2 +
    window is the last that sees key k0 + block_k − 1).  A visited query
    tile applies the mask when it holds rows at or past S, when the key tile
    holds keys at or past S, when a key lies after a query (the tile's last
    key after its first row), or when the tile's last row is at least the
    window past its first key; every other visited tile is wholly unmasked.
    """
    n_qt = -(-s // block_q)
    plan = []
    for k0 in range(0, s, block_k):
        lo, hi = 0, n_qt - 1
        if causal:
            lo = k0 // block_q
            if window > 0:
                hi = min(hi, (k0 + block_k - 2 + window) // block_q)
        masked = tuple(
            qt for qt in range(lo, hi + 1)
            if qt * block_q + block_q > s or k0 + block_k > s
            or (causal and (k0 + block_k - 1 > qt * block_q
                            or (window > 0 and qt * block_q + block_q - 1
                                - k0 >= window))))
        plan.append(TileVisit(lo, hi, masked))
    return plan


def flash_pairs(s: int, causal: bool, window: int, block_q: int = BLOCK_Q,
                block_k: int = BLOCK_K) -> Tuple[int, int]:
    """→ (unmasked (query, key) pairs per head, pairs the kernel's visited
    tiles hold), counted over ``flash_tile_plan``: an unmasked tile holds
    rows × block_k unmasked pairs, a masked one is counted pair by pair."""
    unmasked = visited = 0
    for n, tile in enumerate(flash_tile_plan(s, block_q, block_k, causal,
                                             window)):
        q0 = n * block_q
        rows = min(block_q, s - q0)
        visited += (tile.hi - tile.lo + 1) * rows * block_k
        unmasked += (tile.hi - tile.lo + 1 - len(tile.masked)) * rows \
            * block_k
        i = torch.arange(q0, q0 + rows)[:, None]
        for kt in tile.masked:
            t = torch.arange(kt * block_k, (kt + 1) * block_k)[None, :]
            ok = (t < s) & (i < s)
            if causal:
                ok = ok & (t <= i)
                if window > 0:
                    ok = ok & (t > i - window)
            unmasked += int(ok.sum())
    return unmasked, visited


# dtype → (library, C entry, route name)
_ROUTES = {torch.float32: ("flash_attention", "flash_attention_f32",
                           "simt_f32"),
           torch.bfloat16: ("flash_attention_sm90",
                            "flash_attention_bf16_sm90", "wgmma_bf16")}
# dtype → (C entry of csrc/flash_attention_bwd.cu, route name)
_BWD_ROUTES = {torch.float32: ("flash_attention_bwd_f32", "simt_f32"),
               torch.bfloat16: ("flash_attention_bwd_bf16", "simt_bf16")}


def _lib(dtype: torch.dtype, backward: bool = False):
    from ._build import library
    if backward:
        fn = getattr(library("flash_attention_bwd"), _BWD_ROUTES[dtype][0])
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
        return fn
    lib_name, entry, _ = _ROUTES[dtype]
    fn = getattr(library(lib_name), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int) -> str:
    """Raise on what the CUDA kernels do not take; → the route for q's
    dtype (``"wgmma_bf16"`` or ``"simt_f32"``)."""
    if q.ndim != 4 or q.dtype not in _ROUTES or not q.is_contiguous():
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
    route = _ROUTES[q.dtype][2]
    if route == "wgmma_bf16" and q.device.type != "meta" and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k and v must start on a "
                         "16-byte boundary (TMA reads them)")
    return route


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int) -> torch.Tensor:
    route = _check_args(q, k, v, window)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, h, k.shape[1], s, d,
                        1.0 / math.sqrt(d), int(causal), int(window),
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({route}): "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, *, causal: bool = True,
                             window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The backward kernels on CUDA tensors: the forward's q, k, v and
    output and the output's gradient (all contiguous, one dtype) → (dq, dk,
    dv) in that dtype."""
    _check_args(q, k, v, window)
    for name, t in (("out", out), ("dout", dout)):
        if t.device != q.device or t.dtype != q.dtype \
                or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be a "
                             f"contiguous {q.dtype} tensor of shape "
                             f"{tuple(q.shape)}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    b, h, s, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    entry, route = _BWD_ROUTES[q.dtype]
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    err = _lib(q.dtype, True)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), b, h, k.shape[1], s, d,
        1.0 / math.sqrt(d), int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed "
                           f"({route}): CUDA error {err}")
    flash_attention_backward.launches += 1
    flash_attention_backward.route_launches[route] += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
#: backward launches per route (the kernel pair, per dtype)
flash_attention_backward.route_launches = {"simt_f32": 0, "simt_bf16": 0}


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernels with ``csrc/flash_attention_bwd.cu`` as their
    gradient (saves q, k, v and the output)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, KV, S, D), contiguous, all f32 or all bf16 →
    (B, H, S, D) in q's dtype.

    CUDA tensors go through ``FlashAttentionFn``: the forward launches
    ``csrc/flash_attention_sm90.cu`` for bf16 and ``csrc/flash_attention.cu``
    for f32 (D in ``HEAD_DIMS``), the gradient ``csrc/flash_attention_bwd.cu``;
    CPU tensors take ``flash_attention_ref``.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors; got "
                         f"{q.device}")
    _check_args(q, k, v, window)
    return FlashAttentionFn.apply(q, k, v, bool(causal), int(window))


flash_attention.launches = 0
#: launches per route: the bf16 tensor-core kernel and the f32 SIMT kernel
flash_attention.route_launches = {"wgmma_bf16": 0, "simt_f32": 0}
