"""Registered architectures of the port (h2o-danube-1.8b, mamba2-130m)."""
from .registry import ArchSpec, all_archs, get, register

__all__ = ["ArchSpec", "all_archs", "get", "register"]
