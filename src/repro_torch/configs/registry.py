"""Architecture registry: the reference's ten archs and their configurations.

Port of ``repro/configs/registry.py`` without ``input_specs`` and
``SHAPES`` (they wait with the dry-run tooling).  Each arch module registers
an :class:`ArchSpec`:
  * ``config``       — the exact published configuration
  * ``smoke_config`` — reduced same-family config for CPU smoke tests
  * ``source``       — where the configuration is published
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from ..models import ModelConfig

__all__ = ["ArchSpec", "register", "get", "all_archs"]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    smoke_config: ModelConfig
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
