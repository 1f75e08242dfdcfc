"""musicgen-medium [audio] — 48L d1536 24H (GQA kv=24) d_ff=6144 vocab=2048,
decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only: the EnCodec tokenizer/detokenizer frontend is a stub —
inputs are already EnCodec codebook tokens (vocab 2048), and nothing reads
``audio_frontend``.
"""
from ..models import ModelConfig
from .registry import ArchSpec, register

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    block_pattern=(("attn", "dense"),),
    norm="layernorm", activation="gelu",
    audio_frontend=True,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=64, norm="layernorm", activation="gelu",
    audio_frontend=True, tie_embeddings=False,
    remat=False, dtype="float32",
)

register("musicgen-medium", ArchSpec(
    config=CONFIG,
    smoke_config=SMOKE,
    source="arXiv:2306.05284",
))
