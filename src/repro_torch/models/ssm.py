"""Mamba-2 (SSD — state-space duality) mixer [arXiv:2405.21060].

Port of ``repro/models/ssm.py``.  Multi-head selective SSM with
scalar-per-head decay:

    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t ⊗ x_t          (state update)
    y_t = C_t · h_t + D ⊙ x_t                                (readout)

Prefill uses the chunked SSD algorithm: the sequence is split into chunks of
Q tokens; intra-chunk contributions are dense products over all chunks at
once.  The reference carries the inter-chunk state through a ``lax.scan``
over chunks; here every chunk's state contribution ``dbx`` and decay are
computed at once, one ``ssd_scan`` kernel launch gives the state entering
each chunk, and the inter-chunk readout follows for all chunks in parallel.
The result is the reference's ``chunk_body`` recurrence.  In training the
scan's gradient is its reverse-scan kernel and the gated norm's the
rmsnorm backward kernel.

Decode keeps a recurrent state (B, H, P, N) + conv ring state and performs a
single-step update.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import shard
from ..kernels._dtensor import along
from ..kernels._work import is_dtensor
from ..kernels.rmsnorm import rmsnorm
from ..kernels.ssd_scan import ssd_scan
from .config import ModelConfig
from .params import ParamDef, normal_init, ones_init, scaled_init, zeros_init

__all__ = ["ssm_defs", "ssd_forward", "ssm_decode_step", "SSMCache",
           "init_ssm_cache"]


def _a_log_init(gen, shape, dtype, device):
    """log(U(1, 16)), the reference's ``a_log`` initialiser."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return torch.log(1.0 + 15.0 * u).to(dtype)


def ssm_defs(cfg: ModelConfig, reps: int) -> Dict[str, ParamDef]:
    d = cfg.d_model
    di = cfg.d_inner                    # expand × d_model
    st = cfg.ssm_state
    nh = cfg.ssm_heads                  # di / head_dim
    cw = cfg.ssm_conv_width
    dt = cfg.dtype_
    # in_proj emits [z (di), x (di), B (st), C (st), dt (nh)]
    return {
        "w_in": ParamDef((reps, d, 2 * di + 2 * st + nh),
                         ("layers", "embed", "qkv"), dt, scaled_init(1)),
        "conv_w": ParamDef((reps, cw, di + 2 * st),
                           ("layers", "conv", "qkv"), dt, normal_init(0.1)),
        "conv_b": ParamDef((reps, di + 2 * st), ("layers", "qkv"), dt,
                           zeros_init()),
        "a_log": ParamDef((reps, nh), ("layers", "heads"), torch.float32,
                          _a_log_init),
        "dt_bias": ParamDef((reps, nh), ("layers", "heads"), torch.float32,
                            zeros_init()),
        "d_skip": ParamDef((reps, nh), ("layers", "heads"), torch.float32,
                           ones_init()),
        "norm_scale": ParamDef((reps, di), ("layers", "qkv"), torch.float32,
                               ones_init()),
        "w_out": ParamDef((reps, di, d), ("layers", "qkv", "embed"), dt,
                          scaled_init(1)),
    }


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, cw-1, di + 2·st) — causal-conv ring state
    state: torch.Tensor   # (B, H, P, N) f32 — SSM recurrent state


def init_ssm_cache(cfg: ModelConfig, batch: int, device) -> SSMCache:
    di, st = cfg.d_inner, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    return SSMCache(
        conv=torch.zeros(batch, cfg.ssm_conv_width - 1, di + 2 * st,
                         dtype=cfg.dtype_, device=device),
        state=torch.zeros(batch, nh, hd, st, dtype=torch.float32,
                          device=device),
    )


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, st = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * st]
    dt = proj[..., di + di + 2 * st:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over sequence.  xbc: (B,S,C), w: (cw,C)."""
    cw = w.shape[0]
    if history is None:
        pad = torch.zeros(xbc.shape[0], cw - 1, xbc.shape[2],
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = history
    xpad = torch.cat([pad, xbc], dim=1)                   # (B, S+cw-1, C)
    s = xbc.shape[1]
    out = xpad[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, cw):
        out = out + xpad[:, i:i + s, :] * w[i][None, None, :]
    return F.silu(out + b)


def ssd_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 256,
                return_final_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Chunked SSD over a full sequence (prefill).

    x: (B, S, D) → (B, S, D).  Sequences not divisible by ``chunk`` are
    front-padded with zeros — exactly equivalent for an SSM starting from
    h₀=0 (zero inputs contribute nothing to the state; front pads equal the
    default zero conv history).
    """
    b, s_orig, d = x.shape
    q = min(chunk, s_orig)
    pad = (-s_orig) % q
    if pad:
        x = torch.cat([torch.zeros(b, pad, d, dtype=x.dtype,
                                   device=x.device), x], dim=1)
    b, s, d = x.shape
    di, st = cfg.d_inner, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    nc = s // q
    f32 = torch.float32

    proj = x @ p["w_in"]
    z, xbc_raw, dt_raw = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xs = xbc[..., :di]
    bmat = xbc[..., di:di + st]                               # (B,S,N)
    cmat = xbc[..., di + st:]                                 # (B,S,N)

    a_log, dt_bias, d_skip = _head_params(p)
    dt = F.softplus(dt_raw.to(f32) + dt_bias)                 # (B,S,H)
    a = -torch.exp(a_log)                                     # (H,) negative
    log_decay = a[None, None, :] * dt                         # (B,S,H)

    xh = xs.reshape(b, nc, q, nh, hd).to(f32)
    bh = bmat.reshape(b, nc, q, st).to(f32)
    ch = cmat.reshape(b, nc, q, st).to(f32)
    dtc = dt.reshape(b, nc, q, nh)
    cum = along(lambda t: torch.cumsum(t, dim=2),
                log_decay.reshape(b, nc, q, nh), 2)             # (B,C,Q,H)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))

    # intra-chunk: y_t += Σ_{u≤t} C_t·B_u · exp(cum_t − cum_u) · dt_u·x_u
    # (masked before exp: for t<u the exponent is positive and can overflow)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,C,Q,U,H)
    decay_mat = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                      torch.tensor(-1e30, device=x.device)))
    cb = torch.einsum("bcqn,bcun->bcqu", ch, bh)              # (B,C,Q,U)
    w_intra = cb[..., None] * decay_mat * dtc[:, :, None, :, :]
    y = torch.einsum("bcquh,bcuhp->bcqhp", w_intra, xh)

    # every chunk's own state contribution and decay, then the states
    # entering the chunks from one scan
    rel = torch.exp(cum[:, :, -1:, :] - cum)                  # (B,C,Q,H)
    dbx = torch.einsum("bcqhp,bcqn->bchpn",
                       xh * (rel * dtc)[..., None], bh).contiguous()
    chunk_decay = torch.exp(cum[:, :, -1, :]).contiguous()    # (B,C,H)
    h_before, h_final = ssd_scan(chunk_decay, dbx)

    # inter-chunk: y_t += C_t · exp(cum_t) · h_entering
    y = y + torch.einsum("bcqn,bchpn->bcqhp", ch, h_before) \
        * torch.exp(cum)[..., None]

    y = y.reshape(b, s, nh, hd)
    y = y + d_skip[None, None, :, None] * xs.reshape(b, s, nh, hd).to(f32)
    y = y.reshape(b, s, di)

    # gated RMSNorm (mamba2 style): norm(y) * silu(z)
    y = _gated_norm(y, z, p["norm_scale"])
    out = y.to(x.dtype) @ p["w_out"]
    if pad:
        out = out[:, pad:, :]
    out = shard(out, "batch", "act_seq", "act_embed")
    if return_final_state:
        cw = cfg.ssm_conv_width
        conv_hist = xbc_raw[:, -(cw - 1):, :].to(cfg.dtype_)
        return out, SSMCache(conv=conv_hist.contiguous(), state=h_final)
    return out, None


def _head_params(p: Dict):
    """``a_log``, ``dt_bias`` and ``d_skip``: per-head, replicated under a
    mesh ("heads" may shard them), since the packed projection feeding the
    heads stays replicated ("qkv") and the chunk products reshape the head
    dim, which DTensor cannot propagate a split through."""
    return tuple(shard(p[k], None) for k in ("a_log", "dt_bias", "d_skip"))


def _gated_norm(y: torch.Tensor, z: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """rmsnorm(y, scale) · silu(z), y in f32 (the norm runs the kernel)."""
    return rmsnorm(y.contiguous(), scale, 1e-6) * F.silu(z.to(y.dtype))


def ssm_decode_step(p: Dict, x: torch.Tensor, cache: SSMCache,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, SSMCache]:
    """One-token recurrent update.  x: (B, 1, D).

    The cache is updated in place and returned."""
    b = x.shape[0]
    di, st = cfg.d_inner, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32

    proj = x @ p["w_in"]
    z, xbc, dt_raw = _split_proj(cfg, proj)

    # conv ring state: history (B, cw-1, C) + this token
    full = torch.cat([cache.conv, xbc], dim=1)                # (B,cw,C)
    conv_out = torch.einsum("bwc,wc->bc", full, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :]                   # (B,1,C)

    xs = conv_out[..., :di].reshape(b, nh, hd).to(f32)
    bmat = conv_out[:, 0, di:di + st].to(f32)                 # (B,N)
    cmat = conv_out[:, 0, di + st:].to(f32)                   # (B,N)

    a_log, dt_bias, d_skip = _head_params(p)
    dt = F.softplus(dt_raw[:, 0].to(f32) + dt_bias)
    a = -torch.exp(a_log)
    dec = torch.exp(a[None, :] * dt)                          # (B,H)

    h = cache.state * dec[:, :, None, None] + \
        torch.einsum("bh,bn,bhp->bhpn", dt, bmat, xs)
    y = torch.einsum("bn,bhpn->bhp", cmat, h)                 # (B,H,P)
    y = y + d_skip[None, :, None] * xs
    y = y.reshape(b, 1, di)
    y = _gated_norm(y, z, p["norm_scale"])
    out = shard(y.to(x.dtype) @ p["w_out"], "batch", "act_seq", "act_embed")
    if is_dtensor(cache.state):
        # a sharded cache is replaced, as the reference returns new arrays
        return out, SSMCache(conv=full[:, 1:, :], state=h)
    cache.conv.copy_(full[:, 1:, :])
    cache.state.copy_(h)
    return out, cache
