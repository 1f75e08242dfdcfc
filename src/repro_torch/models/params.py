"""Declarative parameter definitions.

Port of ``repro/models/params.py``.  Every model parameter is declared once
as a :class:`ParamDef` (shape, dtype, initializer) and
``init_tree`` materialises the tree.  The initialisers draw the same
distributions as the reference's, from one ``torch.Generator``; the bits
differ from JAX's, so tests carry weights across instead
(``checkpoint/convert.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

__all__ = ["ParamDef", "init_tree", "normal_init", "zeros_init",
           "ones_init", "scaled_init", "tree_leaves", "tree_map"]

#: An initialiser: (generator, shape, dtype, device) → tensor.
Init = Callable[[torch.Generator, Tuple[int, ...], torch.dtype,
                 torch.device], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: Any = torch.bfloat16
    init: Init = None


def _normal(gen, shape, device, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * std


def normal_init(stddev: float = 0.02) -> Init:
    def f(gen, shape, dtype, device):
        return _normal(gen, shape, device, stddev).to(dtype)
    return f


def scaled_init(fan_in_axis: int = -2) -> Init:
    """LeCun-normal-ish: stddev = 1/sqrt(fan_in)."""
    def f(gen, shape, dtype, device):
        fan_in = shape[fan_in_axis] if shape else 1
        std = 1.0 / np.sqrt(max(1, fan_in))
        return _normal(gen, shape, device, std).to(dtype)
    return f


def zeros_init() -> Init:
    return lambda gen, shape, dtype, device: torch.zeros(
        shape, dtype=dtype, device=device)


def ones_init() -> Init:
    return lambda gen, shape, dtype, device: torch.ones(
        shape, dtype=dtype, device=device)


def tree_leaves(tree, is_leaf=None):
    """Leaves of a dict/list/tuple tree; dicts in sorted key order, as
    ``jax.tree.flatten`` orders them."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k],
                                                             is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn, tree, is_leaf=None):
    """``fn`` over the leaves of a dict/list/tuple tree, keeping its shape
    (NamedTuples stay NamedTuples)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def init_tree(defs, seed: int, device) -> Any:
    """Materialise a ParamDef tree on ``device``: one generator seeded with
    ``seed`` draws the leaves in ``tree_leaves`` order."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    is_def = lambda x: isinstance(x, ParamDef)  # noqa: E731
    vals = {}
    for d in tree_leaves(defs, is_def):
        vals[id(d)] = (d.init or normal_init())(gen, d.shape, d.dtype,
                                                device)
    return tree_map(lambda d: vals[id(d)], defs, is_def)
