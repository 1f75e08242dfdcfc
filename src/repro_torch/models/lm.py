"""Decoder-LM assembly: param defs, forward, prefill, decode, train and
serve steps.

Port of ``repro/models/lm.py``.  The parameter tree keeps the reference's
names and stacked layouts: ``params["blocks"][pos]`` holds the weights of
pattern position ``pos`` for every repeat along a leading ``layers`` axis,
split per repeat here (one ``unbind`` a leaf, so a gradient is stacked back
once) and run by a Python loop where the reference scans.

Steps:
  * ``forward``      — full causal forward (training, and the prefill body);
                       with ``cfg.remat`` and gradients on, each pattern
                       repeat runs under ``torch.utils.checkpoint``
                       (``remat_policy`` "full" recomputes everything,
                       "dots" keeps the matrix products' outputs), the
                       reference's ``jax.checkpoint(body)``
  * ``prefill``      — forward + KV/SSM cache construction
  * ``decode_step``  — one-token serve step against the cache (updates the
                       cache in place, where the reference returns new
                       arrays)
  * ``make_train_step`` — loss and gradients (``cfg.grad_accum``
                       microbatches accumulated in f32), global-norm
                       clipping, the optimizer's update
  * ``make_serve_step`` — greedy decode of one token

Every architecture of the reference's registry runs: dense, sliding-window,
Mamba-2, MoE and hybrid patterns, the parallel attn∥FFN block and
vision-token prefixes, with every option of ``ModelConfig``.  On the card
the gradient goes through the kernels' backward kernels (``RMSNormFn``,
``FlashAttentionFn``, ``SSDScanFn``).

Int8 weight-only serving (``models/quantize.py``): a tree whose leaves are
``QTensor``s serves as the reference's does, the embedding, the unembed and
each block's weights dequantized to ``cfg.dtype_`` where they are used.
Eager PyTorch holds what XLA would fuse, so the port dequantizes tighter
than the reference's whole repeat (one jamba period is 88 GB of bf16): one
sub-layer (a position's mixer, then its FFN) of one repeat at a time, an
MoE layer's experts one expert at a time, in slabs of at most 2^26
elements, the same values bit for bit.  Training never quantizes, as the
reference's train step never reads ``quantize_weights``.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from .config import ModelConfig
from .layers import (AttnCache, apply_norm, attention, attn_defs,
                     dense_ffn, ffn_defs, init_attn_cache, moe_defs, moe_ffn,
                     norm_defs)
from .params import (ParamDef, init_tree, normal_init, ones_init,
                     tree_leaves, tree_map)
from .quantize import QTensor, dequant_tree, dequantize
from .ssm import init_ssm_cache, ssd_forward, ssm_decode_step, ssm_defs

__all__ = ["model_defs", "init_params", "forward", "prefill", "decode_step",
           "cross_entropy", "make_train_step", "make_serve_step",
           "init_cache", "TrainState"]


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
    if ffn == "moe":
        return moe_defs(cfg, reps)
    if ffn == "none":
        return None
    raise ValueError(ffn)


def model_defs(cfg: ModelConfig) -> Dict:
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
    """One (mixer, ffn) position of the pattern for one repeat.  Quantized
    weights are dequantized one sub-layer (the mixer, then the FFN) at a
    time, just before it runs (norms are never quantized)."""
    mixer, ffn = cfg.block_pattern[pos]
    new_cache = None
    h_in = apply_norm(cfg, bp["norm1"]["scale"], x)
    mp = dequant_tree(bp["mixer"], cfg.dtype_)
    if mixer == "attn":
        y, new_cache = attention(mp, h_in, cfg, positions=positions,
                                 cache=cache, cache_index=cache_index,
                                 return_kv=want_cache)
        if cache is None and want_cache:
            new_cache = _build_prefill_attn_cache(*new_cache, cfg, positions,
                                                  cache_len)
    else:  # mamba
        if cache is not None:
            y, new_cache = ssm_decode_step(mp, h_in, cache, cfg)
        else:
            y, new_cache = ssd_forward(mp, h_in, cfg, chunk=ssd_chunk,
                                       return_final_state=want_cache)
    del mp

    if ffn == "none":
        return x + y, new_cache
    if ffn == "moe":
        # int8 experts dequantize one expert at a time inside moe_ffn
        apply_ffn, fp = moe_ffn, bp["ffn"]
    else:
        apply_ffn, fp = dense_ffn, dequant_tree(bp["ffn"], cfg.dtype_)
    if cfg.parallel_block:
        # command-r style: attn and ffn read the same normed input (norm2
        # stays in the tree, unused, as in the reference's)
        return x + y + apply_ffn(fp, h_in, cfg), new_cache
    x = x + y
    h2 = apply_norm(cfg, bp["norm2"]["scale"], x)
    return x + apply_ffn(fp, h2, cfg), new_cache


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
def _embed_tokens(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                  vision_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings; a VLM's ``vision_embeds`` (B, nv, d) replace the
    first nv positions.  A quantized table dequantizes only the rows it
    gathers (elementwise, so the values of the reference's whole-table
    dequantize)."""
    embed = params["embed"]
    if isinstance(embed, QTensor):
        x = (embed.data[tokens.long()].to(torch.float32) * embed.scale) \
            .to(cfg.dtype_)
    else:
        x = embed[tokens.long()]
    if cfg.vision_tokens and vision_embeds is not None:
        nv = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
    return x


def _unembed(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ dequantize(params["embed"], cfg.dtype_).T
    return x @ dequantize(params["lm_head"], cfg.dtype_)


def _layer(tree, r: int):
    """Repeat ``r`` of a stacked tree (leading ``layers`` axis)."""
    return tree_map(lambda a: a[r], tree)


def _unstack(tree, reps: int) -> List:
    """The ``reps`` repeat trees of a stacked parameter tree, one ``unbind``
    a leaf (its gradient is one stack, where ``reps`` selects would each
    scatter into a zero tensor of the whole leaf)."""
    parts = tree_map(lambda a: a.unbind(0), tree,
                     is_leaf=lambda a: isinstance(a, torch.Tensor))
    return [tree_map(lambda t: t[r], parts,
                     is_leaf=lambda a: isinstance(a, tuple)
                     and not hasattr(a, "_fields")) for r in range(reps)]


def _dots_policy(ctx, op, *args, **kwargs):
    """``checkpoint_dots``: keep the outputs of matrix products, recompute
    everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``torch.utils.checkpoint`` as ``cfg.remat_policy`` says
    (the reference's ``jax.checkpoint`` of the scan body)."""
    import functools

    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if cfg.remat_policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _dots_policy))
    if cfg.remat_policy != "full":
        raise ValueError(f"{cfg.name}: remat_policy must be 'full' or "
                         f"'dots'; got {cfg.remat_policy!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _run_blocks(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                positions, caches=None, cache_index=None,
                ssd_chunk: int = 256, want_cache: bool = False,
                cache_len: int = 0):
    """Loop over pattern repeats (the reference's ``_scan_blocks``).

    caches: list (per position) of stacked cache tuples with leading dim =
    repeats, or None.  Decode updates them in place and returns them;
    prefill (``want_cache``) returns newly stacked ones.  A forward without
    caches under gradients runs each repeat under ``cfg.remat``."""
    npos = len(cfg.block_pattern)
    reps = cfg.pattern_repeats
    layers = [_unstack(params["blocks"][pos], reps) for pos in range(npos)]

    def body(x, blk, cache_r):
        """One pattern repeat → (x, each position's cache)."""
        new = []
        for pos in range(npos):
            x, nc = _apply_block_position(
                cfg, pos, blk[pos], x, positions=positions,
                cache=cache_r[pos], cache_index=cache_index,
                ssd_chunk=ssd_chunk, want_cache=want_cache,
                cache_len=cache_len)
            new.append(nc)
        return x, new

    if (cfg.remat and torch.is_grad_enabled() and caches is None
            and not want_cache):
        body = _remat(body, cfg)
    built: List[List] = [[] for _ in range(npos)]
    for r in range(reps):
        cache_r = [_layer(caches[pos], r) if caches is not None else None
                   for pos in range(npos)]
        x, new = body(x, [layers[pos][r] for pos in range(npos)], cache_r)
        for pos in range(npos):
            built[pos].append(new[pos])
    if caches is not None:
        return x, caches
    if not want_cache:
        return x, None
    return x, [type(cs[0])(*(torch.stack(f) for f in zip(*cs)))
               for cs in built]


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            vision_embeds: Optional[torch.Tensor] = None,
            ssd_chunk: int = 256) -> torch.Tensor:
    """Full causal forward → logits (B, S, V)."""
    b, s = tokens.shape
    x = _embed_tokens(params, cfg, tokens, vision_embeds)
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
            vision_embeds: Optional[torch.Tensor] = None,
            ssd_chunk: int = 256, max_len: int = 0):
    """Forward over the prompt, returning (logits, caches).

    ``max_len`` sizes the KV cache for subsequent decoding (defaults to the
    prompt length — pass prompt+decode budget for generation)."""
    b, s = tokens.shape
    max_len = max_len or s
    x = _embed_tokens(params, cfg, tokens, vision_embeds)
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
    x = _embed_tokens(params, cfg, tokens, None)
    x, caches = _run_blocks(params, cfg, x, positions=positions,
                            caches=caches, cache_index=index)
    return _unembed(params, cfg, x), caches


# -------------------------------------------------------------------- loss
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in f32 (over ``mask``'s ones when given)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


class TrainState(NamedTuple):
    params: Dict
    opt_state: Any
    step: torch.Tensor       # () int32, on the CPU


def _value_and_grad(loss_fn, params: Dict, batch: Dict):
    """(loss, grads) of ``loss_fn(params, batch)``, the gradients in a tree
    like ``params`` (a parameter the loss does not read gets zeros, as
    ``jax.grad`` gives)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        live = {id(p): p.detach().requires_grad_(True) for p in leaves}
        loss = loss_fn(tree_map(lambda p: live[id(p)], params), batch)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
    by_id = {i: torch.zeros_like(p) if g is None else g
             for (i, p), g in zip(live.items(), grads)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], params)


def make_train_step(cfg: ModelConfig, optimizer, *, clip_norm: float = 1.0,
                    ssd_chunk: int = 256):
    """Returns train_step(state, batch) → (state, metrics).

    ``cfg.grad_accum > 1`` splits the global batch into microbatches and
    accumulates gradients in f32 before one optimizer update — the
    activation-memory lever when batch × seq blows the card's memory.
    Then the gradients are clipped to ``clip_norm`` by their global norm and
    the optimizer (``optim.adamw``) updates the parameters; metrics are
    ``loss``, ``grad_norm`` (before clipping) and ``step``.
    """
    from ..optim import apply_updates, clip_by_global_norm

    def loss_fn(params, batch):
        logits = forward(params, cfg, batch["tokens"],
                         vision_embeds=batch.get("vision_embeds"),
                         ssd_chunk=ssd_chunk)
        return cross_entropy(logits, batch["labels"], batch.get("mask"))

    def _grads(params, batch):
        a = cfg.grad_accum
        if a <= 1:
            return _value_and_grad(loss_fn, params, batch)
        micro = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        lsum = None
        for i in range(a):
            loss, g = _value_and_grad(loss_fn, params,
                                      {k: v[i] for k, v in micro.items()})
            leaves_g = iter(tree_leaves(g))
            for acc in tree_leaves(gsum):
                acc.add_(next(leaves_g).to(torch.float32))
            lsum = loss if lsum is None else lsum + loss
        return lsum / a, tree_map(lambda g: g / a, gsum)

    def train_step(state: TrainState, batch: Dict):
        loss, grads = _grads(state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        del grads
        params = apply_updates(state.params, updates)
        step = state.step + 1
        metrics = {"loss": loss, "grad_norm": gnorm, "step": step}
        return TrainState(params, opt_state, step), metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """Returns serve_step(params, caches, tokens, index) →
    (next_token, logits, caches) — greedy decode of one token."""

    def serve_step(params, caches, tokens, index):
        logits, caches = decode_step(params, cfg, tokens, caches, index)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], logits, caches

    return serve_step

