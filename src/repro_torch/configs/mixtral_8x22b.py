"""mixtral-8x22b [moe] — 56L d6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
8 experts top-2, SWA [arXiv:2401.04088; hf]."""
from ..models import ModelConfig
from .registry import ArchSpec, register

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    block_pattern=(("attn", "moe"),),
    moe_experts=8, moe_top_k=2,
    sliding_window=4096,
    tie_embeddings=False,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab_size=128,
    block_pattern=(("attn", "moe"),),
    moe_experts=4, moe_top_k=2, moe_group_size=32, capacity_factor=4.0,
    sliding_window=8, tie_embeddings=False,
    remat=False, dtype="float32",
)

register("mixtral-8x22b", ArchSpec(
    config=CONFIG,
    smoke_config=SMOKE,
    rules={
        # kv=8 and E=8 don't divide model=16: replicate KV heads, shard the
        # experts' mlp dim (TP-inside-expert) instead of EP.
        "kv_heads": None,
        "experts": None,
        "expert_mlp": "model",
    },
    skip={},   # SWA ⇒ long_500k runs (O(window) cache)
    source="arXiv:2401.04088",
))
