"""Architecture registry: the reference's ten archs × their input shapes.

Port of ``repro/configs/registry.py``.  Each arch module registers an
:class:`ArchSpec`:
  * ``config``       — the exact published configuration
  * ``smoke_config`` — reduced same-family config for CPU smoke tests
  * ``rules``        — per-arch logical→mesh overrides (e.g. kv_heads=8 can't
                       shard over model=16 → replicate; mixtral's 8 experts
                       shard via TP-on-mlp instead of EP)
  * ``skip``         — shapes this arch skips, with the reason (long_500k for
                       pure full-attention archs)
  * ``source``       — where the configuration is published

The rules are the reference's verbatim, reasons included: they were written
for its model axis of 16, and the port's production mesh has a model axis
of 8 (``launch/mesh.py``; ROADMAP.md lists the rules whose reason no longer
holds there).

``input_specs(arch, shape)`` returns meta-device tensors standing in for
every input of the step the dry run traces (the train step for train
shapes; the serve step — one new token against a seq_len KV cache — for
decode shapes; prefill for prefill shapes), plus the logical axes used to
shard them.  Nothing is allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..models import ModelConfig

__all__ = ["ShapeSpec", "ArchSpec", "SHAPES", "register", "get",
           "all_archs", "input_specs", "input_specs_for", "cache_axes_for"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    smoke_config: ModelConfig
    rules: Dict[str, object] = dataclasses.field(default_factory=dict)
    skip: Dict[str, str] = dataclasses.field(default_factory=dict)
    source: str = ""


_REGISTRY: Dict[str, ArchSpec] = {}


def register(arch_id: str, spec: ArchSpec) -> None:
    _REGISTRY[arch_id] = spec


def get(arch_id: str) -> ArchSpec:
    _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; registered: "
                       f"{', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[arch_id]


def all_archs() -> Tuple[str, ...]:
    _load_all()
    return tuple(sorted(_REGISTRY))


def _load_all() -> None:
    from . import (command_r_plus_104b, h2o_danube_1_8b,  # noqa: F401
                   internvl2_76b, jamba_1_5_large_398b, mamba2_130m,
                   mixtral_8x22b, musicgen_medium, olmoe_1b_7b,
                   phi3_mini_3_8b, qwen1_5_0_5b)


# ------------------------------------------------------------- input specs
def cache_axes_for(cfg: ModelConfig) -> list:
    """Logical axes for the stacked caches (one per pattern position)."""
    from ..models.layers import AttnCache
    from ..models.ssm import SSMCache
    axes = []
    for mixer, _ in cfg.block_pattern:
        if mixer == "attn":
            axes.append(AttnCache(
                k=("layers", "batch", "kv_heads", "cache_seq", "head_dim"),
                v=("layers", "batch", "kv_heads", "cache_seq", "head_dim"),
                slot_pos=("layers", "batch", "cache_seq")))
        else:
            axes.append(SSMCache(
                conv=("layers", "batch", None, "qkv"),
                state=("layers", "batch", "heads", None, "state")))
    return axes


def input_specs(arch_id: str, shape_name: str) -> Dict:
    """Meta-device inputs + logical axes for one (arch × shape) cell."""
    return input_specs_for(get(arch_id).config, shape_name)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs_for(cfg: ModelConfig, shape) -> Dict:
    """As :func:`input_specs` but for an explicit config; ``shape`` is a
    name of :data:`SHAPES` or a :class:`ShapeSpec` of its own."""
    from ..models import init_cache
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    b = shp.global_batch
    out: Dict[str, object] = {}
    axes: Dict[str, object] = {}

    if shp.kind in ("train", "prefill"):
        s = shp.seq_len
        out["tokens"] = _meta((b, s), torch.int32)
        axes["tokens"] = ("batch", "act_seq")
        if shp.kind == "train":
            out["labels"] = _meta((b, s), torch.int32)
            axes["labels"] = ("batch", "act_seq")
        if cfg.vision_tokens:
            out["vision_embeds"] = _meta((b, cfg.vision_tokens, cfg.d_model),
                                         cfg.dtype_)
            axes["vision_embeds"] = ("batch", None, "act_embed")
    else:  # decode: one new token against a seq_len-deep cache
        out["tokens"] = _meta((b, 1), torch.int32)
        axes["tokens"] = ("batch", "act_seq")
        out["caches"] = init_cache(cfg, b, shp.seq_len, device="meta")
        axes["caches"] = cache_axes_for(cfg)
        out["index"] = _meta((), torch.int32)
        axes["index"] = ()
    return {"specs": out, "axes": axes, "shape": shp, "config": cfg}
