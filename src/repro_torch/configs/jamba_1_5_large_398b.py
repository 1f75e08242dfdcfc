"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave
[arXiv:2403.19887; hf].

Block pattern: 8-layer period with the attention layer at index 4 and MoE on
every 2nd layer (4 of 8) — 9 repeats cover the 72 layers.
"""
from ..models import ModelConfig
from .registry import ArchSpec, register

_PATTERN = (
    ("mamba", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
    ("attn", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    block_pattern=_PATTERN,
    moe_experts=16, moe_top_k=2,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=False,
    fsdp=True,
    optimizer_state_dtype="bfloat16",   # 398B: fp32 moments blow the HBM
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128,
    block_pattern=_PATTERN,
    moe_experts=4, moe_top_k=2, moe_group_size=32, capacity_factor=4.0,
    ssm_state=16, ssm_head_dim=32,
    tie_embeddings=False, remat=False, dtype="float32",
)

register("jamba-1.5-large-398b", ArchSpec(
    config=CONFIG,
    smoke_config=SMOKE,
    rules={"kv_heads": None},     # kv=8 < model=16; experts 16/16 EP is fine
    skip={},   # hybrid: long_500k runs (mamba state + 9 attn layers of cache)
    source="arXiv:2403.19887",
))
