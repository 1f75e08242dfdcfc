"""PyTorch/CUDA port of the HSDAG placement search and of the LM serving
path (``repro_torch.models``, ``repro_torch.launch.serve``).

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro_torch/core/gpn.py`` ports ``repro/core/gpn.py``) and imports
nothing of it.  Entry points run on the card unless the caller passes
``device="cpu"``.  The v1 API (``PlacementSpec``, ``PlacementSession``,
``PlacementService``, ``AsyncPlacementServer``, ``AotExecutableCache``,
the platform registry) loads on first use, from ``repro_torch.api``.
"""
from .core import (HSDAG, CompGraph, CurriculumTrainer, FeatureConfig,
                   HSDAGConfig, MultiGraphTrainer, extract_features,
                   paper_platform, simulate)
from .graphs import PAPER_BENCHMARKS, build_corpus

#: names loaded from ``repro_torch.api`` on first use
_API = ("PlacementSpec", "PlacementSession", "PlacementService",
        "AsyncPlacementServer", "AotExecutableCache", "PlacementRequestError",
        "SPEC_VERSION", "MODES",
        "register_platform", "platform_names", "build_platform",
        "parse_platform_spec")

__all__ = ["HSDAG", "CompGraph", "CurriculumTrainer", "FeatureConfig",
           "HSDAGConfig", "MultiGraphTrainer", "build_corpus",
           "extract_features", "paper_platform", "simulate",
           "PAPER_BENCHMARKS", *_API]


def __getattr__(name):
    if name in _API:
        from . import api
        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
