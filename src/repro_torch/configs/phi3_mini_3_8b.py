"""phi3-mini-3.8b [dense] — 32L d3072 32H (GQA kv=32) d_ff=8192 vocab=32064,
RoPE SwiGLU GQA [arXiv:2404.14219; unverified]."""
from ..models import ModelConfig
from .registry import ArchSpec, register

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    block_pattern=(("attn", "dense"),),
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="phi3-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=128, tie_embeddings=False,
    remat=False, dtype="float32",
)

register("phi3-mini-3.8b", ArchSpec(
    config=CONFIG,
    smoke_config=SMOKE,
    source="arXiv:2404.14219",
))
