"""ModelConfig — one declarative config covering the LM families.

Port of ``repro/models/config.py`` holding the fields the ported serving
path reads; ``dtype_`` is a torch dtype.  The options of families this slice
does not port stay as fields so that ``check_ported`` can reject them; the
training and sharding knobs (remat, scan, FSDP, MoE dispatch, ...) come with
the slice that first reads them.

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
