"""Registered architectures of the port: the reference's ten (dense,
sliding-window, Mamba-2, MoE, hybrid, parallel-block, VLM and audio
backbones) and the dry run's input shapes."""
from .registry import (SHAPES, ArchSpec, ShapeSpec, all_archs,
                       cache_axes_for, get, input_specs, register)

__all__ = ["ArchSpec", "ShapeSpec", "SHAPES", "all_archs", "get",
           "input_specs", "cache_axes_for", "register"]
