"""Optimizers: the functional AdamW, schedules and clipping the LM train
step uses, and the ``Adam`` class the placement policy trains with."""
from .adamw import (Adam, GradientTransform, OptState, adam, adamw,
                    apply_updates)
from .clip import clip_by_global_norm, global_norm
from .schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "Adam", "adam", "adamw", "GradientTransform", "OptState",
    "apply_updates", "constant", "cosine_decay", "linear_warmup_cosine",
    "clip_by_global_norm", "global_norm",
]
