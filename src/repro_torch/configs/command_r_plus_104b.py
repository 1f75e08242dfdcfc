"""command-r-plus-104b [dense] — 64L d12288 96H (GQA kv=8) d_ff=33792
vocab=256000, GQA, no-bias, parallel attn∥ffn block
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from ..models import ModelConfig
from .registry import ArchSpec, register

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab_size=256000,
    block_pattern=(("attn", "dense"),),
    norm="layernorm", parallel_block=True,
    tie_embeddings=True,          # Cohere ties embeddings
)

SMOKE = ModelConfig(
    name="command-r-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab_size=256,
    norm="layernorm", parallel_block=True, tie_embeddings=True,
    remat=False, dtype="float32",
)

register("command-r-plus-104b", ArchSpec(
    config=CONFIG,
    smoke_config=SMOKE,
    source="hf:CohereForAI/c4ai-command-r-plus",
))
