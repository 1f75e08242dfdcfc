"""Compressed gradient collectives (int8 + error feedback).

Port of ``repro/distributed/compression.py``.  ``compressed_psum_mean``
replaces the f32 ring all-reduce with:

    1. block-quantize the local vector to int8 (one f32 scale a 256 block)
    2. ``all_to_all_single`` the int8 blocks and their scales (each rank
       owns 1/N of the vector)
    3. dequantize + mean in f32 locally
    4. requantize the reduced chunk, ``all_gather`` it (int8 + scales)

Wire bytes: 2·N·1 B (+ scales ≈ 2·N/256·4 B) against 2·N·4 B for a ring
all-reduce.  Quantization error is absorbed by **error feedback** (the
residual is added to the next step's gradient).

Each rank calls these with its own tensors, as under ``torchrun``; the
reference calls them inside ``shard_map``.  Rounding is half to even on
both sides (``torch.round``, ``jnp.round``), so the wire format is the
reference's bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_mean",
           "compressed_allreduce_tree"]

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., k·BLOCK) f32 → (int8 values, f32 scales per block)."""
    shape = x.shape
    blocks = x.reshape(*shape[:-1], -1, BLOCK)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q.reshape(shape), scale[..., 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    shape = q.shape
    blocks = q.reshape(*shape[:-1], -1, BLOCK).to(torch.float32)
    return (blocks * scale[..., None]).reshape(shape)


def compressed_psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean all-reduce of a flat f32 vector over ``group`` (default: the
    whole world) with an int8 wire format.

    ``x`` is this rank's vector (the same length on every rank); its length
    must be divisible by ``world · BLOCK`` (pad upstream).
    """
    num = dist.get_world_size(group)
    n = x.shape[0]
    chunk = n // num
    if chunk * num != n or chunk % BLOCK:
        raise ValueError(f"vector length {n} is not a multiple of "
                         f"{num} ranks x {BLOCK}")
    # 1. quantize the full local vector
    q, scale = quantize_int8(x)
    # 2. all_to_all: rank d receives everyone's chunk d
    q_recv = torch.empty_like(q)
    s_recv = torch.empty_like(scale)
    dist.all_to_all_single(q_recv, q.contiguous(), group=group)
    dist.all_to_all_single(s_recv, scale.contiguous(), group=group)
    # 3. dequantize + mean in f32
    deq = dequantize_int8(q_recv.reshape(num, chunk),
                          s_recv.reshape(num, chunk // BLOCK))
    reduced = deq.mean(dim=0)                              # (chunk,) f32
    # 4. requantize + all_gather
    qr, sr = quantize_int8(reduced)
    q_all = torch.empty(num * chunk, dtype=torch.int8, device=x.device)
    s_all = torch.empty(num * (chunk // BLOCK), dtype=sr.dtype,
                        device=x.device)
    dist.all_gather_into_tensor(q_all, qr.contiguous(), group=group)
    dist.all_gather_into_tensor(s_all, sr.contiguous(), group=group)
    return dequantize_int8(q_all, s_all)


def compressed_allreduce_tree(grads: Sequence[torch.Tensor], group=None,
                              error_fb: Optional[torch.Tensor] = None
                              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """A list of gradients → (their compressed mean over ``group``, the new
    error-feedback residual).  ``error_fb`` is the previous call's residual
    (``None`` on step 0)."""
    num = dist.get_world_size(group)
    sizes = [g.numel() for g in grads]
    vec = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    vec = torch.nn.functional.pad(vec, (0, (-vec.numel()) % (num * BLOCK)))
    if error_fb is not None:
        vec = vec + error_fb
    reduced = compressed_psum_mean(vec, group)
    # error feedback (EF-SGD): the part of the *local* contribution that the
    # wire format dropped — local, no extra collective.
    q, s = quantize_int8(vec)
    new_err = vec - dequantize_int8(q, s)
    out, off = [], 0
    for g, sz in zip(grads, sizes):
        out.append(reduced[off:off + sz].reshape(g.shape).to(g.dtype))
        off += sz
    return out, new_err
