"""Gradient clipping utilities.

Port of ``repro/optim/clip.py`` over the port's dict/list trees of
tensors."""
from __future__ import annotations

import torch

from ..models.params import tree_leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (leaves in sorted-key order, as the reference sums them)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """→ (tree scaled by min(1, max_norm / norm), norm); each leaf is scaled
    in float32 and cast back to its dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                    tree), norm
