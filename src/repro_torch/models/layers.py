"""Transformer layer library: norms, RoPE, GQA/SWA attention with KV cache,
SwiGLU/GELU FFN.

Port of ``repro/models/layers.py`` for the dense and sliding-window
decoders.  Parameters keep the reference's names and layouts (``wq`` is
(d, h, dh) per layer, applied as ``einsum("bsd,dhk->bshk")``).  RMSNorm runs
the ``rmsnorm`` kernel; prefill self-attention runs the ``flash_attention``
kernel; decode attention (one query against the ring-buffer cache) is plain
PyTorch, as no reference kernel computes it.  MoE waits for a later slice.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.rmsnorm import rmsnorm
from .config import ModelConfig
from .params import ParamDef, ones_init, scaled_init, zeros_init

__all__ = [
    "rms_norm", "layer_norm", "norm_defs", "apply_norm",
    "rope", "attn_defs", "attention", "AttnCache", "init_attn_cache",
    "ffn_defs", "dense_ffn", "check_ported",
]


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for options this slice does not port."""
    waiting = (
        (any(f == "moe" for _, f in cfg.block_pattern), "MoE FFN layers"),
        (cfg.attn_head_merge, "attn_head_merge"),
        (cfg.attn_logit_softcap > 0, "attn_logit_softcap > 0"),
        (cfg.parallel_block, "parallel_block"),
        (cfg.vision_tokens > 0, "vision_tokens"),
        (cfg.audio_frontend, "audio_frontend"),
        (cfg.quantize_weights, "quantize_weights (int8 serving)"),
    )
    for on, what in waiting:
        if on:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported to repro_torch yet "
                f"(ROADMAP.md queue 1, 'LM substrate')")


# ------------------------------------------------------------------- norms
def norm_defs(cfg: ModelConfig, reps: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((reps, cfg.d_model), torch.float32,
                              ones_init())}


def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm(x.contiguous(), scale, eps)


def layer_norm(scale: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale).to(dtype)


def apply_norm(cfg: ModelConfig, scale: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    return rms_norm(scale, x) if cfg.norm == "rmsnorm" else layer_norm(scale, x)


# -------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, Dh); positions: (B, S) int.

    Frequencies and angles in f32, as the reference computes them."""
    dh = x.shape[-1]
    half = dh // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exponent)
    angles = positions.to(torch.float32)[..., None] * freqs     # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
def attn_defs(cfg: ModelConfig, reps: int) -> Dict[str, ParamDef]:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = cfg.dtype_
    defs = {
        "wq": ParamDef((reps, d, h, dh), dt, scaled_init(1)),
        "wk": ParamDef((reps, d, kv, dh), dt, scaled_init(1)),
        "wv": ParamDef((reps, d, kv, dh), dt, scaled_init(1)),
        "wo": ParamDef((reps, h, dh, d), dt, scaled_init(1)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((reps, h, dh), dt, zeros_init())
        defs["bk"] = ParamDef((reps, kv, dh), dt, zeros_init())
        defs["bv"] = ParamDef((reps, kv, dh), dt, zeros_init())
    return defs


class AttnCache(NamedTuple):
    """Ring-buffer KV cache (window = full seq for dense attention, the SWA
    window for sliding-window layers)."""
    k: torch.Tensor          # (B, KV, W, Dh)
    v: torch.Tensor          # (B, KV, W, Dh)
    slot_pos: torch.Tensor   # (B, W) int32 absolute position per slot, -1=empty


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device, dtype=None) -> AttnCache:
    w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv, dh = cfg.n_kv_heads, cfg.head_dim_
    dt = dtype or cfg.dtype_
    return AttnCache(
        k=torch.zeros(batch, kv, w, dh, dtype=dt, device=device),
        v=torch.zeros(batch, kv, w, dh, dtype=dt, device=device),
        slot_pos=torch.full((batch, w), -1, dtype=torch.int32, device=device),
    )


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _project_qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k, scale):
    """q: (B,S,H,Dh), k: (B,T,KV,Dh) → scores (B,KV,G,S,T) in f32."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, dh)
    return torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                        k.to(torch.float32)) * scale


def _attend(scores, v, mask):
    """scores (B,KV,G,S,T), v (B,T,KV,Dh) → (B,S,H,Dh)."""
    scores = torch.where(mask, scores,
                         torch.tensor(-1e30, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    b, kvh, g, s, t = scores.shape
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    return ctx.reshape(b, s, kvh * g, -1)


def attention(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor,
              cache: Optional[AttnCache] = None,
              cache_index: Optional[int] = None,
              return_kv: bool = False):
    """GQA attention.

    Prefill: ``cache=None`` → causal (+sliding window) self-attention over
    ``x`` through the flash kernel, with ``positions`` = 0..S-1 (the kernel
    masks by index); returns (y, None), or (y, (k, v)) with ``return_kv``
    — the rotated (B, S, KV, Dh) keys and values the prefill cache is
    packed from.

    Decode: ``cache`` holds past KV, ``cache_index`` is the current absolute
    position; x has S=1.  The cache is updated in place and returned.
    """
    b, s, d = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim_)
    q, k, v = _project_qkv(p, x, cfg, positions)

    if cache is None:
        y = flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            causal=True, window=cfg.sliding_window)
        y = y.transpose(1, 2)                                # (B,S,H,Dh)
        new_cache = (k, v) if return_kv else None
    else:
        # decode: write this token's K/V into its ring-buffer slot.  The
        # reference blends with a one-hot mask, cache·(1−hit) + new·hit,
        # which for finite values leaves every other slot bit for bit and
        # puts exactly the new K/V in the slot: the in-place write below
        # gives the same values without a pass over the whole cache.
        w = cache.k.shape[2]
        slot = int(cache_index) % w
        cache.k[:, :, slot] = k[:, 0]
        cache.v[:, :, slot] = v[:, 0]
        cache.slot_pos[:, slot] = positions[:, 0].to(torch.int32)

        t_pos = cache.slot_pos                               # (B,W)
        valid = t_pos >= 0
        causal = valid[:, None, :] & (t_pos[:, None, :] <=
                                      positions[:, :, None])
        if cfg.sliding_window:
            causal &= t_pos[:, None, :] > (positions[:, :, None] -
                                           cfg.sliding_window)
        mask = causal[:, None, None, :, :]
        k_all = cache.k.transpose(1, 2)                      # (B,W,KV,Dh)
        v_all = cache.v.transpose(1, 2)
        scores = _gqa_scores(q, k_all, scale)
        y = _attend(scores, v_all, mask)
        new_cache = cache

    y = y.to(x.dtype)
    h, dh = y.shape[2], y.shape[3]
    out = y.reshape(b, s, h * dh) @ p["wo"].reshape(h * dh, -1)
    return out, new_cache


# ---------------------------------------------------------------- dense FFN
def ffn_defs(cfg: ModelConfig, reps: int) -> Dict[str, ParamDef]:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype_
    if cfg.activation == "swiglu":
        return {
            "w_gate": ParamDef((reps, d, f), dt, scaled_init(1)),
            "w_up": ParamDef((reps, d, f), dt, scaled_init(1)),
            "w_down": ParamDef((reps, f, d), dt, scaled_init(1)),
        }
    return {
        "w_in": ParamDef((reps, d, f), dt, scaled_init(1)),
        "w_out": ParamDef((reps, f, d), dt, scaled_init(1)),
    }


def dense_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]
