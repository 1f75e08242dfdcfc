"""ModelConfig — one declarative config covering the LM families.

Port of ``repro/models/config.py`` holding the fields the ported serving
and training paths read, with the reference's defaults; ``dtype_`` is a
torch dtype.  Every option the reference's model runs is here (the logit
softcap, merged-head attention, int8 weight serving); the sharding knobs
(scan, FSDP, the optimizer state dtype of the dry-runs) come with
``launch/mesh``.

``block_pattern`` is the repeating unit of (mixer, ffn) pairs; the decoder
loops over ``n_layers // len(pattern)`` repeats of it.

  dense transformer : (("attn", "dense"),)
  MoE transformer   : (("attn", "moe"),)
  mamba2            : (("mamba", "none"),)          # Mamba2 blocks have no FFN
  jamba hybrid      : 8-layer unit, attn at index 4, MoE every 2nd layer
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig"]

Pattern = Tuple[Tuple[str, str], ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: Pattern = (("attn", "dense"),)
    head_dim: Optional[int] = None
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: Optional[int] = None       # expert hidden (defaults to d_ff)
    capacity_factor: float = 1.25
    moe_group_size: int = 1024           # GShard dispatch group tokens
    # attention options
    qkv_bias: bool = False
    sliding_window: int = 0              # 0 = full attention
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0
    attn_head_merge: bool = False        # merged (batch × heads) attention
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    # misc
    activation: str = "swiglu"           # "swiglu" | "gelu"
    norm: str = "rmsnorm"                # "rmsnorm" | "layernorm"
    parallel_block: bool = False         # command-r style attn∥ffn
    tie_embeddings: bool = True
    vision_tokens: int = 0               # VLM stub: prepended patch embeddings
    audio_frontend: bool = False         # audio stub flag (decoder-only body)
    dtype: str = "bfloat16"
    # training
    remat: bool = True
    remat_policy: str = "full"           # "full" | "dots" (save matmul outputs
    # — less recompute, more resident bytes) | applies when remat=True
    grad_accum: int = 1                  # microbatch accumulation steps
    quantize_weights: bool = False       # int8 weight-only serving (B2)

    # ------------------------------------------------------------- derived
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def pattern_repeats(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, \
            (self.name, self.n_layers, len(self.block_pattern))
        return self.n_layers // len(self.block_pattern)

    @property
    def dtype_(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def num_params(self) -> float:
        """Analytic parameter count (per-family; used for 6·N·D roofline)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        total = v * d * (1 if self.tie_embeddings else 2)
        for mixer, ffn in self.block_pattern:
            reps = self.pattern_repeats
            if mixer == "attn":
                qkvo = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
                total += reps * qkvo
            elif mixer == "mamba":
                di, st = self.d_inner, self.ssm_state
                nh = self.ssm_heads
                in_proj = d * (2 * di + 2 * st + nh)
                total += reps * (in_proj + di * d + nh + nh +
                                 self.ssm_conv_width * (di + 2 * st))
            if ffn == "dense":
                mult = 3 if self.activation == "swiglu" else 2
                total += reps * mult * d * f
            elif ffn == "moe":
                fe = self.moe_d_ff or f
                mult = 3 if self.activation == "swiglu" else 2
                total += reps * (self.moe_experts * mult * d * fe +
                                 d * self.moe_experts)
            total += reps * 2 * d   # norms
        return float(total)

    def active_params(self) -> float:
        """Active (per-token) params — MoE uses top-k of the experts."""
        if self.moe_experts == 0:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        fe = self.moe_d_ff or f
        mult = 3 if self.activation == "swiglu" else 2
        dense_every = self.num_params()
        # subtract inactive expert weights
        n_moe_layers = sum(1 for _, ffn in self.block_pattern
                           if ffn == "moe") * self.pattern_repeats
        inactive = n_moe_layers * (self.moe_experts - self.moe_top_k) * \
            mult * d * fe
        return float(dense_every - inactive)
