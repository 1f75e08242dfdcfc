"""Optimizers."""
from .adamw import Adam

__all__ = ["Adam"]
