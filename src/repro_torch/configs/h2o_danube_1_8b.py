"""h2o-danube-1.8b [dense] — 24L d2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
llama+mistral mix with sliding-window attention [arXiv:2401.16818; hf]."""
from ..models import ModelConfig
from .registry import ArchSpec, register

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000,
    block_pattern=(("attn", "dense"),),
    sliding_window=4096,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="danube-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab_size=128, sliding_window=8,
    tie_embeddings=False, dtype="float32",
)

register("h2o-danube-1.8b", ArchSpec(
    config=CONFIG,
    smoke_config=SMOKE,
    source="arXiv:2401.16818",
))
