"""internvl2-76b [vlm] — 80L d8192 64H (GQA kv=8) d_ff=28672 vocab=128256,
InternViT + LLM backbone [arXiv:2404.16821; unverified].

Only the transformer backbone is modeled; the vision frontend is a stub —
``forward`` and ``prefill`` take precomputed patch embeddings
(B, 256, d_model) as ``vision_embeds``, which replace the first 256 token
positions.
"""
from ..models import ModelConfig
from .registry import ArchSpec, register

CONFIG = ModelConfig(
    name="internvl2-76b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    block_pattern=(("attn", "dense"),),
    vision_tokens=256,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab_size=256, vision_tokens=4, tie_embeddings=False,
    remat=False, dtype="float32",
)

register("internvl2-76b", ArchSpec(
    config=CONFIG,
    smoke_config=SMOKE,
    source="arXiv:2404.16821",
))
