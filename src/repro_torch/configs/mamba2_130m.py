"""mamba2-130m [ssm] — 24L d768 (attention-free) vocab=50280, ssm_state=128,
SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from ..models import ModelConfig
from .registry import ArchSpec, register

CONFIG = ModelConfig(
    name="mamba2-130m",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    block_pattern=(("mamba", "none"),),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=128,
    block_pattern=(("mamba", "none"),),
    ssm_state=16, ssm_head_dim=32, tie_embeddings=True,
    dtype="float32",
)

register("mamba2-130m", ArchSpec(
    config=CONFIG,
    smoke_config=SMOKE,
    source="arXiv:2405.21060",
))
