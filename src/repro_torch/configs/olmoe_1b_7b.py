"""olmoe-1b-7b [moe] — 16L d2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
64 experts top-8 [arXiv:2409.02060; hf]."""
from ..models import ModelConfig
from .registry import ArchSpec, register

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    block_pattern=(("attn", "moe"),),
    moe_experts=64, moe_top_k=8, moe_d_ff=1024,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="olmoe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab_size=128,
    block_pattern=(("attn", "moe"),),
    moe_experts=8, moe_top_k=2, moe_d_ff=32, moe_group_size=32,
    capacity_factor=4.0,
    tie_embeddings=False, remat=False, dtype="float32",
)

register("olmoe-1b-7b", ArchSpec(
    config=CONFIG,
    smoke_config=SMOKE,
    source="arXiv:2409.02060",
))
