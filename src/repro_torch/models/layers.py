"""Transformer layer library: norms, RoPE, GQA/SWA attention with KV cache,
SwiGLU/GELU FFN, and GShard-style capacity-routed MoE.

Port of ``repro/models/layers.py``.  Parameters keep the reference's names
and layouts (``wq`` is (d, h, dh) per layer, applied as
``einsum("bsd,dhk->bshk")``; an expert's ``w_gate`` is (E, d, f)).  RMSNorm
runs the ``rmsnorm`` kernel; prefill and training self-attention runs the
``flash_attention`` kernel, and on the card the gradient of each goes
through its backward kernel; decode attention (one query against the
ring-buffer cache) and the MoE layer are plain PyTorch, as the reference
computes them outside any kernel too.

Two attention options of the reference: ``attn_logit_softcap`` caps the
scaled scores at ``cap·tanh(s / cap)`` before the mask, in prefill (the
flash kernels' capped instantiations) and in decode (``_gqa_scores``);
``attn_head_merge`` runs prefill self-attention with (batch × heads)
merged into the kernel's batch.  The reference's merged path applies no
cap, so with both options prefill is uncapped and decode capped, as
there.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..distributed.sharding import shard
from ..kernels._work import is_dtensor
from ..kernels.flash_attention import flash_attention
from ..kernels.rmsnorm import rmsnorm
from .config import ModelConfig
from .params import ParamDef, ones_init, scaled_init, zeros_init
from .quantize import QTensor, dequantize

__all__ = [
    "rms_norm", "layer_norm", "norm_defs", "apply_norm",
    "rope", "attn_defs", "attention", "AttnCache", "init_attn_cache",
    "ffn_defs", "dense_ffn", "moe_defs", "moe_ffn", "moe_route", "MoERoute",
]


# ------------------------------------------------------------------- norms
def norm_defs(cfg: ModelConfig, reps: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((reps, cfg.d_model), ("layers", "embed"),
                              torch.float32, ones_init())}


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
        "wq": ParamDef((reps, d, h, dh), ("layers", "embed", "heads",
                                          "head_dim"), dt, scaled_init(1)),
        "wk": ParamDef((reps, d, kv, dh), ("layers", "embed", "kv_heads",
                                           "head_dim"), dt, scaled_init(1)),
        "wv": ParamDef((reps, d, kv, dh), ("layers", "embed", "kv_heads",
                                           "head_dim"), dt, scaled_init(1)),
        "wo": ParamDef((reps, h, dh, d), ("layers", "heads", "head_dim",
                                          "embed"), dt, scaled_init(1)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((reps, h, dh), ("layers", "heads", "head_dim"),
                              dt, zeros_init())
        defs["bk"] = ParamDef((reps, kv, dh), ("layers", "kv_heads",
                                               "head_dim"), dt, zeros_init())
        defs["bv"] = ParamDef((reps, kv, dh), ("layers", "kv_heads",
                                               "head_dim"), dt, zeros_init())
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
    q = shard(q, "batch", "act_seq", "heads", "head_dim")
    k = shard(k, "batch", "act_seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "act_seq", "kv_heads", "head_dim")
    return q, k, v


def _gqa_scores(q, k, scale, softcap: float = 0.0):
    """q: (B,S,H,Dh), k: (B,T,KV,Dh) → scores (B,KV,G,S,T) in f32, capped
    at ``softcap·tanh(s / softcap)`` when ``softcap`` > 0."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    return scores


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
    masks by index), capped by ``cfg.attn_logit_softcap`` or, with
    ``cfg.attn_head_merge``, merged over (batch × heads) and uncapped;
    returns (y, None), or (y, (k, v)) with ``return_kv`` — the rotated
    (B, S, KV, Dh) keys and values the prefill cache is packed from.

    Decode: ``cache`` holds past KV, ``cache_index`` is the current absolute
    position; x has S=1.  The cache is updated in place and returned.
    """
    b, s, d = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim_)
    q, k, v = _project_qkv(p, x, cfg, positions)

    if cache is None:
        if cfg.attn_head_merge:
            y = _head_merged_attention(q, k, v, cfg)
        elif is_dtensor(q):
            # under a mesh each rank transposes its local slices
            from ..kernels._dtensor import flash_attention_local
            y = flash_attention_local(q, k, v, causal=True,
                                      window=cfg.sliding_window,
                                      softcap=cfg.attn_logit_softcap,
                                      heads_dim=2)
        else:
            y = flash_attention(q.transpose(1, 2).contiguous(),
                                k.transpose(1, 2).contiguous(),
                                v.transpose(1, 2).contiguous(),
                                causal=True, window=cfg.sliding_window,
                                softcap=cfg.attn_logit_softcap)
            y = y.transpose(1, 2)                            # (B,S,H,Dh)
        new_cache = (k, v) if return_kv else None
    else:
        # decode: write this token's K/V into its ring-buffer slot.  The
        # reference blends with a one-hot mask, cache·(1−hit) + new·hit,
        # which for finite values leaves every other slot bit for bit and
        # puts exactly the new K/V in the slot: the in-place write below
        # gives the same values without a pass over the whole cache.
        w = cache.k.shape[2]
        slot = int(cache_index) % w
        if is_dtensor(cache.k):
            # a sharded cache takes the reference's blend, elementwise over
            # its (possibly "model"-sharded) slots, into new tensors
            hit = torch.arange(w, device=x.device) == slot
            hk = hit.view(1, 1, w, 1).to(cache.k.dtype)
            cache = AttnCache(
                cache.k * (1 - hk) + k.transpose(1, 2) * hk,
                cache.v * (1 - hk) + v.transpose(1, 2) * hk,
                torch.where(hit.view(1, w), positions[:, :1].to(torch.int32),
                            cache.slot_pos))
        else:
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
        if is_dtensor(q):
            # under a mesh each rank attends over its local cache slice
            from ..kernels._dtensor import decode_attention_local
            y = decode_attention_local(q, k_all, v_all, mask, scale,
                                       cfg.attn_logit_softcap)
        else:
            scores = _gqa_scores(q, k_all, scale, cfg.attn_logit_softcap)
            y = _attend(scores, v_all, mask)
        new_cache = cache

    y = y.to(x.dtype)
    y = shard(y, "batch", "act_seq", "heads", "head_dim")
    h, dh = y.shape[2], y.shape[3]
    out = y.reshape(b, s, h * dh) @ p["wo"].reshape(h * dh, -1)
    return shard(out, "batch", "act_seq", "act_embed"), new_cache


def _head_merged_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Prefill self-attention with (batch × heads) merged into the batch
    (the reference's ``_head_merged_attention``, its TP fallback for head
    counts that do not divide the model axis): GQA K/V repeated to full
    heads, the flash kernel on (B·H, 1, S, Dh), no logit cap (the
    reference's merged path applies none).  A head's work in the kernel does
    not depend on where it sits in the grid, so this equals the unmerged
    uncapped attention.  q: (B,S,H,Dh), k/v: (B,S,KV,Dh) → (B,S,H,Dh)."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    qm, km, vm = (shard(t.transpose(1, 2).reshape(b * h, 1, s, dh),
                        "merged_bh", None, None, None) for t in (q, k, v))
    ym = flash_attention(qm, km, vm, causal=True, window=cfg.sliding_window)
    return ym.reshape(b, h, s, dh).transpose(1, 2)


# ---------------------------------------------------------------- dense FFN
def ffn_defs(cfg: ModelConfig, reps: int) -> Dict[str, ParamDef]:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype_
    if cfg.activation == "swiglu":
        return {
            "w_gate": ParamDef((reps, d, f), ("layers", "embed", "mlp"), dt,
                               scaled_init(1)),
            "w_up": ParamDef((reps, d, f), ("layers", "embed", "mlp"), dt,
                             scaled_init(1)),
            "w_down": ParamDef((reps, f, d), ("layers", "mlp", "embed"), dt,
                               scaled_init(1)),
        }
    return {
        "w_in": ParamDef((reps, d, f), ("layers", "embed", "mlp"), dt,
                         scaled_init(1)),
        "w_out": ParamDef((reps, f, d), ("layers", "mlp", "embed"), dt,
                          scaled_init(1)),
    }


def dense_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        h = shard(h, "batch", "act_seq", "mlp")
        out = h @ p["w_down"]
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_in"], approximate="tanh")
        h = shard(h, "batch", "act_seq", "mlp")
        out = h @ p["w_out"]
    return shard(out, "batch", "act_seq", "act_embed")


# ---------------------------------------------------------------------- MoE
def moe_defs(cfg: ModelConfig, reps: int) -> Dict[str, ParamDef]:
    d, dt = cfg.d_model, cfg.dtype_
    e = cfg.moe_experts
    f = cfg.moe_d_ff or cfg.d_ff
    # the router's scaled_init(0) takes the repeat count as its fan-in, as
    # the reference's does
    return {
        "router": ParamDef((reps, d, e), ("layers", "embed", "experts"),
                           torch.float32, scaled_init(0)),
        "w_gate": ParamDef((reps, e, d, f), ("layers", "experts", "embed",
                                             "expert_mlp"), dt,
                           scaled_init(-2)),
        "w_up": ParamDef((reps, e, d, f), ("layers", "experts", "embed",
                                           "expert_mlp"), dt,
                         scaled_init(-2)),
        "w_down": ParamDef((reps, e, f, d), ("layers", "experts",
                                             "expert_mlp", "embed"), dt,
                           scaled_init(-2)),
    }


class MoERoute(NamedTuple):
    """Where :func:`moe_route` sends each (token, choice) of n tokens."""
    groups: int              # G groups of ``group_size`` tokens
    group_size: int
    capacity: int            # C slots per expert and group
    rows: int                # E·G·C: the expert batch's rows
    slot: torch.Tensor       # (n, k) int64 row of the expert batch
    #                          (expert-major, then group, then slot), or
    #                          ``rows`` where the expert's capacity ran out
    gates: torch.Tensor      # (n, k) f32 router weights, renormalised

    def kept(self) -> torch.Tensor:
        """(n, k) bool: the assignments that found a slot."""
        return self.slot < self.rows


def moe_route(router: torch.Tensor, x: torch.Tensor,
              cfg: ModelConfig) -> MoERoute:
    """GShard capacity routing of ``x`` (n, d) with ``router`` (d, E), as
    indices: the reference's groups, capacity, kept and dropped tokens and
    gates (``repro/models/layers.py`` ``moe_ffn``) without its one-hot
    (G, Sg, E, C) dispatch tensors.

    Tokens form G groups of Sg, the largest divisor of n up to
    ``moe_group_size``.  Each expert takes at most C tokens of a group; the
    slots go to choice 0 of every token in token order, then choice 1, ...,
    and an assignment past C is dropped.  Ties among router probabilities go
    to the lower expert index, as ``lax.top_k`` breaks them."""
    n = x.shape[0]
    e, k = cfg.moe_experts, cfg.moe_top_k
    sg = min(cfg.moe_group_size, n)
    while n % sg:            # largest divisor of n ≤ the configured group
        sg -= 1
    g = n // sg
    cap = min(int(math.ceil(sg * k * cfg.capacity_factor / e / 4.0) * 4), sg)

    # a quantized tree dequantizes the f32 router to the model dtype, which
    # the reference's einsum promotes back to f32
    probs = torch.softmax(x.to(torch.float32) @ router.to(torch.float32),
                          dim=-1)                                 # (n, E)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    # slot of each assignment within its (group, expert): how many of the
    # group's assignments before it in (choice, token) order chose the same
    # expert.  A stable sort by (group, expert) keeps that order within
    # each bucket, so the slot is the distance from the bucket's start.
    bucket = (ids.view(g, sg, k).transpose(1, 2)
              + torch.arange(g, device=x.device).view(g, 1, 1) * e)
    keys, order = torch.sort(bucket.reshape(-1), stable=True)
    ranks = torch.arange(keys.numel(), device=x.device) \
        - torch.searchsorted(keys, keys)
    pos = torch.empty_like(ranks).scatter_(0, order, ranks)
    pos = pos.view(g, k, sg).transpose(1, 2).reshape(n, k)
    group = torch.arange(n, device=x.device).div(sg, rounding_mode="floor")
    slot = ids * (g * cap) + group[:, None] * cap + pos
    rows = e * g * cap
    return MoERoute(g, sg, cap, rows, torch.where(pos < cap, slot, rows),
                    gates)


def _experts(p: Dict, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Each expert's FFN on its (E, R, d) rows → (E, R, d): batched
    products, or with int8 weights (``QTensor``s of (E, d, f)) one expert
    at a time, its slices dequantized just before its products, so that no
    dequantized copy of all E experts exists."""
    def ffn(w_gate, w_up, w_down, xs):
        if cfg.activation == "swiglu":
            h = F.silu(torch.matmul(xs, w_gate)) * torch.matmul(xs, w_up)
        else:
            h = F.gelu(torch.matmul(xs, w_gate), approximate="tanh")
        return torch.matmul(h, w_down)
    names = ("w_gate", "w_up", "w_down")
    if not isinstance(p["w_gate"], QTensor):
        return ffn(*(p[k] for k in names), xe)
    out = torch.empty_like(xe)
    for i in range(xe.shape[0]):
        ws = [dequantize(QTensor(p[k].data[i], p[k].scale), cfg.dtype_)
              for k in names]
        out[i] = ffn(*ws, xe[i])
    return out


def _moe(p: Dict, router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
         e0: int = 0) -> torch.Tensor:
    """The MoE layer on plain tensors whose expert weights hold experts
    e0, e0+1, ... (all of them by default): route, gather each held
    expert's kept tokens, run the experts, sum each token's kept outputs
    of those experts weighted by its gates.  With every expert held this is
    the whole layer; with a slice, the rank's partial sum."""
    b, s, d = x.shape
    n, e = b * s, cfg.moe_experts
    wg = p["w_gate"]
    el = (wg.data if isinstance(wg, QTensor) else wg).shape[0]
    xf = x.reshape(n, d)
    route = moe_route(router, xf, cfg)
    rows = route.rows
    k = route.slot.shape[1]
    # the token in each slot of the expert batch; an empty slot computes on
    # token 0 and nothing reads it, and dropped assignments all write the
    # spare last entry
    tokens = torch.zeros(rows + 1, dtype=torch.int64, device=x.device)
    tokens[route.slot.reshape(-1)] = torch.arange(
        n, device=x.device).repeat_interleave(k)
    lo, hi = e0 * (rows // e), (e0 + el) * (rows // e)
    xe = xf[tokens[lo:hi]].view(el, -1, d)
    ye = _experts(p, xe, cfg).view(hi - lo, d)
    kept = route.kept()
    if el != e:
        kept = kept & (route.slot >= lo) & (route.slot < hi)
    w = torch.where(kept, route.gates, 0.0).to(ye.dtype)
    picked = ye[torch.where(kept, route.slot - lo, 0)]      # (n, k, d)
    y = torch.bmm(w[:, None, :], picked)[:, 0]
    return y.view(b, s, d).to(x.dtype)


def _moe_dtensor(p: Dict, x, cfg: ModelConfig):
    """The MoE layer on DTensors: each rank routes its own tokens (batch
    sharded as x is) with the replicated router and runs the experts it
    holds — a slice of the experts ("experts" sharded, EP) or of their
    hidden dim ("expert_mlp" sharded, TP inside each expert).  Where a mesh
    dim shards the weights, the output is a partial sum over it, which the
    next layout reduces; a mesh dim that shards the tokens gathers the
    weights (FSDP's all-gather)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    px = [p_ if p_ == Shard(0) else Replicate() for p_ in x.placements]
    names = ("w_gate", "w_up", "w_down")
    # int8 weights dequantize whole (each rank's shards) under a mesh
    p = {n: dequantize(p[n], cfg.dtype_) for n in names + ("router",)}
    # each weight's expert dim 0 and hidden dim (2 for w_gate/w_up, 1 for
    # w_down) may stay sharded on a mesh dim the tokens do not use
    pw = {n: [q if isinstance(q, Shard) and px[i] == Replicate()
              and q.dim in ((0, 2) if n != "w_down" else (0, 1))
              else Replicate() for i, q in enumerate(p[n].placements)]
          for n in names}
    # the three weights must agree on an even split of the experts
    e0, chunk = 0, cfg.moe_experts
    for i in range(mesh.ndim):
        if any(pw[n][i] == Shard(0) for n in names) and (
                chunk % mesh.size(i)
                or not all(pw[n][i] == Shard(0) for n in names)):
            for n in names:
                pw[n][i] = Replicate()
        if pw["w_gate"][i] == Shard(0):
            chunk //= mesh.size(i)
            e0 += mesh.get_local_rank(i) * chunk
    from ..kernels._dtensor import _local
    wl = {n: _local(p[n], mesh, pw[n]) for n in names}
    router = p["router"]
    if isinstance(router, DTensor):
        router = _local(router, mesh, [Replicate()] * mesh.ndim)
    xl = _local(x, mesh, px)
    y = _moe(wl, router, xl, cfg, e0)
    py = [Partial() if any(isinstance(pw[n][i], Shard) for n in names)
          else px[i] for i in range(mesh.ndim)]
    return DTensor.from_local(y.contiguous(), mesh, py, run_check=False,
                              shape=x.shape, stride=(x.shape[1] * x.shape[2],
                                                     x.shape[2], 1))


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """GShard-style capacity-routed top-k MoE.

    Routes with :func:`moe_route`, gathers each expert's kept tokens into
    an (E, G·C, d) batch, runs the experts as batched products (one expert
    at a time on int8 weights, ``_experts``), then sums each token's kept
    expert outputs weighted by its gates cast to the activation dtype (the
    reference's ``combine.astype(ye.dtype)``).  Under a mesh each rank does
    this for its own tokens and experts (``_moe_dtensor``)."""
    if is_dtensor(x):
        y = _moe_dtensor(p, x, cfg)
    else:
        y = _moe(p, dequantize(p["router"], cfg.dtype_), x, cfg)
    return shard(y, "batch", "act_seq", "act_embed")
