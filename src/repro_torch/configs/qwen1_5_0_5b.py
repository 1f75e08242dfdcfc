"""qwen1.5-0.5b [dense] — 24L d1024 16H (GQA kv=16) d_ff=2816 vocab=151936,
QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from ..models import ModelConfig
from .registry import ArchSpec, register

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151936,
    block_pattern=(("attn", "dense"),),
    qkv_bias=True,
    tie_embeddings=True,           # qwen1.5-0.5B ties embeddings
)

SMOKE = ModelConfig(
    name="qwen-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=256, qkv_bias=True, tie_embeddings=True,
    remat=False, dtype="float32",
)

register("qwen1.5-0.5b", ArchSpec(
    config=CONFIG,
    smoke_config=SMOKE,
    source="hf:Qwen/Qwen1.5-0.5B",
))
