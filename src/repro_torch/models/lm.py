"""Decoder-LM assembly: param defs, forward, prefill, decode, serve step.

Port of ``repro/models/lm.py`` for serving.  The parameter tree keeps the
reference's names and stacked layouts: ``params["blocks"][pos]`` holds the
weights of pattern position ``pos`` for every repeat along a leading
``layers`` axis, indexed here by a Python loop where the reference scans.

Steps:
  * ``forward``      — full causal forward
  * ``prefill``      — forward + KV/SSM cache construction
  * ``decode_step``  — one-token serve step against the cache (updates the
                       cache in place, where the reference returns new
                       arrays)
  * ``make_serve_step`` — greedy decode of one token

The train step (``cross_entropy``, remat, ``make_train_step``) and int8
weight serving wait for a later slice (ROADMAP.md queue 1, 'LM substrate').
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .config import ModelConfig
from .layers import (AttnCache, apply_norm, attention, attn_defs,
                     check_ported, dense_ffn, ffn_defs, init_attn_cache,
                     norm_defs)
from .params import ParamDef, init_tree, normal_init, ones_init, tree_map
from .ssm import init_ssm_cache, ssd_forward, ssm_decode_step, ssm_defs

__all__ = ["model_defs", "init_params", "forward", "prefill", "decode_step",
           "make_serve_step", "init_cache"]


# ------------------------------------------------------------------- defs
def _mixer_defs(cfg: ModelConfig, mixer: str, reps: int):
    if mixer == "attn":
        return attn_defs(cfg, reps)
    if mixer == "mamba":
        return ssm_defs(cfg, reps)
    raise ValueError(mixer)


def _ffn_defs(cfg: ModelConfig, ffn: str, reps: int):
    if ffn == "dense":
        return ffn_defs(cfg, reps)
    if ffn == "none":
        return None
    raise ValueError(ffn)


def model_defs(cfg: ModelConfig) -> Dict:
    check_ported(cfg)
    reps = cfg.pattern_repeats
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), cfg.dtype_,
                          normal_init(0.02)),
        "final_norm": ParamDef((cfg.d_model,), torch.float32, ones_init()),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   cfg.dtype_, normal_init(0.02))
    blocks = []
    for mixer, ffn in cfg.block_pattern:
        blk: Dict[str, Any] = {
            "norm1": norm_defs(cfg, reps),
            "mixer": _mixer_defs(cfg, mixer, reps),
        }
        fd = _ffn_defs(cfg, ffn, reps)
        if fd is not None:
            blk["norm2"] = norm_defs(cfg, reps)
            blk["ffn"] = fd
        blocks.append(blk)
    defs["blocks"] = blocks
    return defs


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Random weights from ``seed`` on ``device``, the reference's
    distributions (not its bits)."""
    return init_tree(model_defs(cfg), seed, device)


# ------------------------------------------------------------------ blocks
def _apply_block_position(cfg: ModelConfig, pos: int, bp: Dict,
                          x: torch.Tensor, *, positions,
                          cache=None, cache_index=None,
                          ssd_chunk: int = 256, want_cache: bool = False,
                          cache_len: int = 0):
    """One (mixer, ffn) position of the pattern for one repeat."""
    mixer, ffn = cfg.block_pattern[pos]
    new_cache = None
    h_in = apply_norm(cfg, bp["norm1"]["scale"], x)
    if mixer == "attn":
        y, new_cache = attention(bp["mixer"], h_in, cfg, positions=positions,
                                 cache=cache, cache_index=cache_index,
                                 return_kv=want_cache)
        if cache is None and want_cache:
            new_cache = _build_prefill_attn_cache(*new_cache, cfg, positions,
                                                  cache_len)
    else:  # mamba
        if cache is not None:
            y, new_cache = ssm_decode_step(bp["mixer"], h_in, cache, cfg)
        else:
            y, new_cache = ssd_forward(bp["mixer"], h_in, cfg,
                                       chunk=ssd_chunk,
                                       return_final_state=want_cache)

    x = x + y
    if ffn != "none":
        h2 = apply_norm(cfg, bp["norm2"]["scale"], x)
        x = x + dense_ffn(bp["ffn"], h2, cfg)
    return x, new_cache


def _build_prefill_attn_cache(k: torch.Tensor, v: torch.Tensor,
                              cfg: ModelConfig, positions: torch.Tensor,
                              max_len: int) -> AttnCache:
    """Pack the prefill's rotated K/V (B, S, KV, Dh) into the ring buffer.

    The reference projects K/V a second time here; the port takes the ones
    ``attention`` computed, the same values.  The cache width is
    ``min(max_len, window)`` — decode continues filling slots at
    ``pos % width``, so tokens are packed via a cyclic roll here.
    """
    b, s = k.shape[:2]
    w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    keep = min(s, w)
    p0 = s - keep                           # first kept absolute position
    kw = k[:, -keep:].transpose(1, 2)       # (B,KV,keep,Dh)
    vw = v[:, -keep:].transpose(1, 2)
    pos_keep = positions[:, -keep:].to(torch.int32)
    pad = w - keep
    if pad:
        zk = torch.zeros(kw.shape[:2] + (pad,) + kw.shape[3:],
                         dtype=kw.dtype, device=kw.device)
        kw = torch.cat([kw, zk], dim=2)
        vw = torch.cat([vw, zk], dim=2)
        pos_keep = torch.cat(
            [pos_keep, torch.full((b, pad), -1, dtype=torch.int32,
                                  device=pos_keep.device)], dim=1)
    # kept positions p0..s-1 occupy slots (p0..s-1) % w — a contiguous cyclic
    # range, so packing is a roll by p0 % w.
    shift = p0 % w
    kc = torch.roll(kw, shift, dims=2)
    vc = torch.roll(vw, shift, dims=2)
    pc = torch.roll(pos_keep, shift, dims=1)
    return AttnCache(k=kc.to(cfg.dtype_), v=vc.to(cfg.dtype_), slot_pos=pc)


# ----------------------------------------------------------------- forward
def _embed_tokens(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _unembed(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def _layer(tree, r: int):
    """Repeat ``r`` of a stacked tree (leading ``layers`` axis)."""
    return tree_map(lambda a: a[r], tree)


def _run_blocks(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                positions, caches=None, cache_index=None,
                ssd_chunk: int = 256, want_cache: bool = False,
                cache_len: int = 0):
    """Loop over pattern repeats (the reference's ``_scan_blocks``).

    caches: list (per position) of stacked cache tuples with leading dim =
    repeats, or None.  Decode updates them in place and returns them;
    prefill (``want_cache``) returns newly stacked ones."""
    check_ported(cfg)
    npos = len(cfg.block_pattern)
    built: List[List] = [[] for _ in range(npos)]
    for r in range(cfg.pattern_repeats):
        for pos in range(npos):
            cache_p = _layer(caches[pos], r) if caches is not None else None
            x, nc = _apply_block_position(
                cfg, pos, _layer(params["blocks"][pos], r), x,
                positions=positions, cache=cache_p, cache_index=cache_index,
                ssd_chunk=ssd_chunk, want_cache=want_cache,
                cache_len=cache_len)
            if want_cache:
                built[pos].append(nc)
    if caches is not None:
        return x, caches
    if want_cache:
        return x, [type(cs[0])(*(torch.stack(f) for f in zip(*cs)))
                   for cs in built]
    return x, None


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            ssd_chunk: int = 256) -> torch.Tensor:
    """Full causal forward → logits (B, S, V)."""
    b, s = tokens.shape
    x = _embed_tokens(params, tokens)
    x, _ = _run_blocks(params, cfg, x, positions=_positions(b, s, x.device),
                       ssd_chunk=ssd_chunk)
    return _unembed(params, cfg, x)


# ------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> list:
    """Stacked (per pattern position, leading dim = repeats) empty caches."""
    reps = cfg.pattern_repeats
    caches = []
    for mixer, _ in cfg.block_pattern:
        if mixer == "attn":
            c = init_attn_cache(cfg, batch, max_len, device)
        else:
            c = init_ssm_cache(cfg, batch, device)
        caches.append(type(c)(*(a[None].repeat((reps,) + (1,) * a.ndim)
                                for a in c)))
    return caches


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            ssd_chunk: int = 256, max_len: int = 0):
    """Forward over the prompt, returning (logits, caches).

    ``max_len`` sizes the KV cache for subsequent decoding (defaults to the
    prompt length — pass prompt+decode budget for generation)."""
    b, s = tokens.shape
    max_len = max_len or s
    x = _embed_tokens(params, tokens)
    x, caches = _run_blocks(params, cfg, x,
                            positions=_positions(b, s, x.device),
                            ssd_chunk=ssd_chunk, want_cache=True,
                            cache_len=max_len)
    return _unembed(params, cfg, x), caches


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                caches: list, index: int):
    """One serving step: tokens (B, 1) at absolute position ``index``.

    ``caches`` is updated in place and returned; a cache passed here must
    not be used again at an earlier position."""
    b = tokens.shape[0]
    positions = torch.full((b, 1), int(index), dtype=torch.int32,
                           device=tokens.device)
    x = _embed_tokens(params, tokens)
    x, caches = _run_blocks(params, cfg, x, positions=positions,
                            caches=caches, cache_index=index)
    return _unembed(params, cfg, x), caches


def make_serve_step(cfg: ModelConfig):
    """Returns serve_step(params, caches, tokens, index) →
    (next_token, logits, caches) — greedy decode of one token."""

    def serve_step(params, caches, tokens, index):
        logits, caches = decode_step(params, cfg, tokens, caches, index)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], logits, caches

    return serve_step

