"""Architecture registry: the ported archs and their configurations.

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
        raise KeyError(
            f"arch {arch_id!r} is not ported to repro_torch; ported: "
            f"{', '.join(sorted(_REGISTRY))} (the others wait in ROADMAP.md "
            f"queue 1, 'LM substrate')")
    return _REGISTRY[arch_id]


def all_archs() -> Tuple[str, ...]:
    _load_all()
    return tuple(sorted(_REGISTRY))


def _load_all() -> None:
    from . import h2o_danube_1_8b, mamba2_130m  # noqa: F401
