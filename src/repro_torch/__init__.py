"""PyTorch/CUDA port of the HSDAG placement search and of the LM serving
path (``repro_torch.models``, ``repro_torch.launch.serve``).

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro_torch/core/gpn.py`` ports ``repro/core/gpn.py``) and imports
nothing of it.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from .core import (HSDAG, CompGraph, CurriculumTrainer, FeatureConfig,
                   HSDAGConfig, MultiGraphTrainer, extract_features,
                   paper_platform, simulate)
from .graphs import PAPER_BENCHMARKS, build_corpus

__all__ = ["HSDAG", "CompGraph", "CurriculumTrainer", "FeatureConfig",
           "HSDAGConfig", "MultiGraphTrainer", "build_corpus",
           "extract_features", "paper_platform", "simulate",
           "PAPER_BENCHMARKS"]
