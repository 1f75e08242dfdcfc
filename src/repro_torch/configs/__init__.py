"""Registered architectures of the port: the reference's ten (dense,
sliding-window, Mamba-2, MoE, hybrid, parallel-block, VLM and audio
backbones)."""
from .registry import ArchSpec, all_archs, get, register

__all__ = ["ArchSpec", "all_archs", "get", "register"]
