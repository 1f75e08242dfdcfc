"""The deterministic synthetic token pipeline the LM launcher trains on."""
from .pipeline import DataConfig, SyntheticTokens

__all__ = ["SyntheticTokens", "DataConfig"]
