"""Flash attention kernel — the LM's prefill self-attention.

Port of ``repro/kernels/flash_attention.py``: online-softmax attention with
GQA head grouping (head h reads KV head h // (H / KV)), a causal mask and an
optional sliding window, f32 softmax statistics and accumulation, and the
output in q's dtype.

``flash_attention`` runs CUDA tensors through ``FlashAttentionFn``, on one
of two routes chosen by dtype, each on the tensor cores (``wgmma``, fed by
TMA), a forward and a backward of two kernels (dq, then dk and dv; no
atomics, so a step gives the same bits every run).  Each forward also
writes each row's log-sum-exp (base 2 of the scores scaled by
log2(e)/sqrt(D)), which ``FlashAttentionFn`` saves beside q, k, v and the
output for the backward:

* ``wgmma_bf16``: the forward ``csrc/flash_attention_sm90.cu`` and the
  backward ``csrc/flash_attention_bwd_sm90.cu``.
* ``wgmma_tf32x3``: the forward ``csrc/flash_attention_tf32_sm90.cu`` and
  the backward ``csrc/flash_attention_bwd_tf32_sm90.cu``, float32 through
  tf32 instructions with each product split in three (a_lo·b_hi +
  a_hi·b_lo + a_hi·b_hi, ``csrc/sm90_common.cuh``), within 1e-5 of the
  plain f32 version where one tf32 product would not be.  A pre-pass launch
  in each writes the split planes into scratch the wrapper allocates.

CPU tensors run the plain PyTorch version ``flash_attention_ref`` (the port
of ``repro/kernels/ref.py::flash_attention_ref``), which autograd
differentiates.  All apply ``window`` only under ``causal``, as ``ref.py``
does.

``softcap`` > 0 caps the scaled scores at ``softcap·tanh(s / softcap)``
before the mask (Gemma 2's attention logit softcapping, the reference's
``attn_logit_softcap`` in ``repro/models/layers.py::_gqa_scores``; its
Pallas kernel has none).  Each of the four kernels has a capped
instantiation beside the uncapped one; a CUDA tensor with a cap launches
the capped kernels (``flash_attention.capped_launches``,
``flash_attention_backward.capped_launches``).  Under a cap the bf16
route's saved log-sum-exp is of the capped scores; the f32 route saves each
row's largest raw score instead, the anchor its capped kernels take every
exponent against (``C·(tanh(x) − tanh(x_M))`` by a difference form on the
f32 pipes, ``csrc/sm90_common.cuh``), and its backward sums each row's
normaliser itself.

``flash_tile_plan`` is the Python mirror of the loops that walk key tiles
for a query tile (the forwards, and the dq kernels at their own tile sizes):
which key tiles each query tile visits and which of them apply the in-tile
mask; ``flash_bwd_tile_plan`` is the dk/dv kernels': which query tiles each
key tile is visited by, and which of them mask.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _work

__all__ = ["flash_attention", "flash_attention_ref", "flash_mask",
           "flash_attention_work",
           "flash_tile_plan", "flash_pairs", "TileVisit", "HEAD_DIMS",
           "BLOCK_Q", "BLOCK_K", "FlashAttentionFn",
           "flash_attention_backward", "flash_attention_forward",
           "flash_bwd_tile_plan", "TF32_FWD_TILES", "TF32_DQ_TILES",
           "TF32_DKV_TILES", "SM90_DQ_BLOCK_Q", "SM90_DQ_BLOCK_K",
           "SM90_DKV_BLOCK_Q", "SM90_DKV_BLOCK_K"]

#: head dims the CUDA kernels are compiled for
HEAD_DIMS = (64, 80, 96, 128)
#: query rows and keys per tile of the bf16 kernel (kBQ, kBK in
#: ``csrc/flash_attention_sm90.cu``)
BLOCK_Q = 128
BLOCK_K = 128
#: the f32 kernels' tiles per head dim, (query rows, keys): the forward
#: (``csrc/flash_attention_tf32_sm90.cu``: 128 query rows a block against key
#: tiles of kBK, FWD_TILES), the backward's dq kernel (64 query rows a block
#: against key tiles of kBK, DQ_TILES) and dk/dv kernel (64 keys a block
#: against query tiles of kBQ, DKV_TILES; ``csrc/flash_attention_bwd_tf32_
#: sm90.cu``): shared memory holds each element twice (the tf32 split)
TF32_FWD_TILES = {64: (128, 64), 80: (128, 64), 96: (128, 64),
                  128: (128, 32)}
TF32_DQ_TILES = {64: (64, 64), 80: (64, 64), 96: (64, 32), 128: (64, 32)}
TF32_DKV_TILES = {64: (64, 64), 80: (32, 64), 96: (32, 64), 128: (16, 64)}
#: the bf16 backward's tiles (``csrc/flash_attention_bwd_sm90.cu``): its dq
#: kernel takes 128 query rows a block against key tiles of 64 (kDqBQ,
#: kDqBK; ``flash_tile_plan``), its dk/dv kernel 128 keys a block against
#: query tiles of 64 (kDkvBK, kDkvBQ; ``flash_bwd_tile_plan``)
SM90_DQ_BLOCK_Q = 128
SM90_DQ_BLOCK_K = 64
SM90_DKV_BLOCK_Q = 64
SM90_DKV_BLOCK_K = 128


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
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: q (B, H, S, D), k/v (B, KV, S, D) → (B, H, S, D)
    in q's dtype; f32 softmax (f64 for f64 inputs), the scaled scores capped
    at ``softcap·tanh(s / softcap)`` when ``softcap`` > 0."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    g = h // kv
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(b, kv, g, s, d).to(acc)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(acc)) / math.sqrt(d)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    mask = flash_mask(s, causal, window, q.device)
    if mask is not None:
        scores = torch.where(mask, scores, torch.tensor(-1e30,
                                                        device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.to(acc))
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


# dtype → (library, C entry, route name); both forwards write the rows'
# log-sum-exp, and the f32 entry takes one more pointer, its scratch
_ROUTES = {torch.float32: ("flash_attention_tf32_sm90",
                           "flash_attention_f32_tf32_sm90", "wgmma_tf32x3"),
           torch.bfloat16: ("flash_attention_sm90",
                            "flash_attention_bf16_sm90", "wgmma_bf16")}
# dtype → (library, C entry, route name) of the backward; the f32 entry
# takes the bf16 one's arguments and its scratch
_BWD_ROUTES = {torch.float32: ("flash_attention_bwd_tf32_sm90",
                               "flash_attention_bwd_f32_tf32_sm90",
                               "wgmma_tf32x3"),
               torch.bfloat16: ("flash_attention_bwd_sm90",
                                "flash_attention_bwd_bf16_sm90",
                                "wgmma_bf16")}


def _argtypes(dtype: torch.dtype, backward: bool = False) -> list:
    """The ctypes parameter list of the C entry of ``dtype``'s route: the
    tensors' pointers (the f32 route's last its scratch), B, H, KV, S, D,
    scale, causal, window, softcap and the stream."""
    n_ptr = (10 if backward else 5) + (dtype == torch.float32)
    return [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p]


def _lib(dtype: torch.dtype, backward: bool = False):
    from ._build import library
    lib_name, entry, _ = (_BWD_ROUTES if backward else _ROUTES)[dtype]
    fn = getattr(library(lib_name), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _argtypes(dtype, backward)
    return fn


def _scratch(q: torch.Tensor, kv: int, backward: bool) -> torch.Tensor:
    """The f32 route's scratch for one launch at q's shape: the tf32 planes
    its pre-pass writes (``<entry>_scratch`` of the route's library)."""
    from ._build import library
    lib_name, entry, _ = (_BWD_ROUTES if backward else _ROUTES)[q.dtype]
    fn = getattr(library(lib_name), entry + "_scratch")
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 5
    b, h, s, d = q.shape
    return torch.empty(fn(b, h, kv, s, d), dtype=torch.float32,
                       device=q.device)


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int, softcap: float = 0.0) -> str:
    """Raise on what the CUDA kernels do not take; → the route for q's
    dtype (``"wgmma_bf16"`` or ``"wgmma_tf32x3"``)."""
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
    if not (softcap >= 0 and math.isfinite(softcap)):
        raise ValueError(f"flash_attention: softcap must be finite and >= 0 "
                         f"(0 for none); got {softcap}")
    route = _ROUTES[q.dtype][2]
    if route == "wgmma_bf16" and q.device.type != "meta" and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k and v must start on a "
                         "16-byte boundary (TMA reads them)")
    return route


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors, outside autograd → (output, the
    rows' (B, H, S) f32 log-sum-exp in base 2 of the (capped) scores scaled
    by log2(e)/sqrt(D); on the f32 route with a cap, each row's largest raw
    score q·k, the backward's anchor)."""
    route = _check_args(q, k, v, window, softcap)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    if route == "wgmma_tf32x3":
        scratch = _scratch(q, k.shape[1], False)
        ptrs += (scratch.data_ptr(),)
    err = _lib(q.dtype)(*ptrs, b, h, k.shape[1], s, d, 1.0 / math.sqrt(d),
                        int(causal), int(window), float(softcap),
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({route}): "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    flash_attention.capped_launches += softcap > 0
    return out, lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor,
                             lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             softcap: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The backward kernels on CUDA tensors: the forward's q, k, v and
    output, the output's gradient (all contiguous, one dtype) and the
    row statistic ``flash_attention_forward`` returned with the same
    ``softcap`` (the log-sum-exp, or the f32 route's anchors under a cap)
    → (dq, dk, dv) in that dtype."""
    route = _check_args(q, k, v, window, softcap)
    for name, t in (("out", out), ("dout", dout)):
        if t.device != q.device or t.dtype != q.dtype \
                or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be a "
                             f"contiguous {q.dtype} tensor of shape "
                             f"{tuple(q.shape)}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    b, h, s, d = q.shape
    if lse is None or lse.device != q.device \
            or lse.dtype != torch.float32 or lse.shape != (b, h, s) \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention backward: takes the forward's "
                         f"contiguous float32 lse of shape {(b, h, s)}; got "
                         f"{None if lse is None else tuple(lse.shape)}")
    if route == "wgmma_bf16" and q.device.type != "meta" and any(
            t.data_ptr() % 16 for t in (out, dout)):
        raise ValueError("flash_attention backward: bf16 out and dout "
                         "must start on a 16-byte boundary (TMA and "
                         "vector loads read them)")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    dsum = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), dsum.data_ptr())
    if route == "wgmma_tf32x3":
        scratch = _scratch(q, k.shape[1], True)
        ptrs += (scratch.data_ptr(),)
    err = _lib(q.dtype, True)(
        *ptrs, b, h, k.shape[1], s, d,
        1.0 / math.sqrt(d), int(causal), int(window), float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed "
                           f"({route}): CUDA error {err}")
    flash_attention_backward.launches += 1
    flash_attention_backward.route_launches[route] += 1
    flash_attention_backward.capped_launches += softcap > 0
    return dq, dk, dv


flash_attention_backward.launches = 0
#: launches of the capped kernels (``softcap`` > 0), on either route
flash_attention_backward.capped_launches = 0
#: backward launches per route (the kernel pair, per dtype)
flash_attention_backward.route_launches = {"wgmma_tf32x3": 0,
                                           "wgmma_bf16": 0}


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel of q's route with that route's backward kernels as
    its gradient (saves q, k, v, the output and the rows' statistic, the
    log-sum-exp or under a cap on the f32 route the anchors; a recompute
    under remat saves them again)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            window=ctx.window, softcap=ctx.softcap)
        return dq, dk, dv, None, None, None


def flash_attention_work(b: int, h: int, kv: int, s: int, d: int,
                         dtype: torch.dtype, causal: bool = True,
                         window: int = 0, backward: bool = False):
    """(operations, bytes) of one launch at q (B, H, S, D), k and v (B, KV,
    S, D) in ``dtype``, over the unmasked (query, key) pairs
    (``flash_pairs``' first count).  The forward reads q, k, v and writes
    the output: 4·D operations a pair (two products); the backward reads q,
    k, v, the output and its gradient and writes dq, dk, dv: 10·D a pair
    (its five products)."""
    pairs = _work.causal_pairs(s, causal, window)
    esize = dtype.itemsize
    if backward:
        return (10 * b * h * d * pairs,
                esize * (3 * b * h * s * d + 4 * b * kv * s * d))
    return (4 * b * h * d * pairs,
            esize * (2 * b * h * s * d + 2 * b * kv * s * d))


def _counted(q, k, v, causal, window, softcap):
    """The shape-only / counted route (``kernels/_work.py``); the Function
    also saves the rows' f32 log-sum-exp."""
    b, h, s, d = q.shape
    # sizes, not tensors, in the closures: the spec lives as long as the
    # autograd graph, and must not keep q or k alive where the kernel's
    # Function would free them (under remat)
    kv, dtype = k.shape[1], q.dtype
    lse = [((b, h, s), torch.float32)]
    spec = _work.KernelSpec(
        "flash_attention",
        lambda q_, k_, v_: flash_attention_ref(q_, k_, v_, causal=causal,
                                               window=window,
                                               softcap=softcap),
        [(tuple(q.shape), dtype)], lse,
        lambda bwd: flash_attention_work(b, h, kv, s, d, dtype, causal,
                                         window, bwd))
    return _work.counted_call(spec, q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, KV, S, D), contiguous, all f32 or all bf16 →
    (B, H, S, D) in q's dtype; ``softcap`` > 0 caps the scaled scores.

    CUDA tensors go through ``FlashAttentionFn`` (D in ``HEAD_DIMS``): bf16
    launches ``csrc/flash_attention_sm90.cu`` and, for the gradient,
    ``csrc/flash_attention_bwd_sm90.cu``; f32
    ``csrc/flash_attention_tf32_sm90.cu`` and
    ``csrc/flash_attention_bwd_tf32_sm90.cu``.  CPU tensors take
    ``flash_attention_ref``.  DTensors run each rank's (batch, head) slice
    on its local tensors (``kernels/_dtensor.py``); fake tensors, and meta
    or CPU tensors while the work counter is active, take the counting
    routes of ``kernels/_work.py``.
    """
    if type(q) is not torch.Tensor or _work.COUNTER.active:
        if _work.is_dtensor(q):
            from ._dtensor import flash_attention_local
            return flash_attention_local(q, k, v, causal=causal,
                                         window=window, softcap=softcap)
        if _work.is_shape_only(q) or (_work.COUNTER.active
                                      and q.device.type == "cpu"):
            return _counted(q, k, v, causal, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors; got "
                         f"{q.device}")
    _check_args(q, k, v, window, softcap)
    return FlashAttentionFn.apply(q, k, v, bool(causal), int(window),
                                  float(softcap))


flash_attention.launches = 0
#: launches of the capped kernels (``softcap`` > 0), on either route
flash_attention.capped_launches = 0
#: launches per route: the bf16 kernel and the f32 kernel (split tf32)
flash_attention.route_launches = {"wgmma_bf16": 0, "wgmma_tf32x3": 0}
