"""Declarative parameter definitions.

Port of ``repro/models/params.py``.  Every model parameter is declared once
as a :class:`ParamDef` (shape, logical axes, dtype, initializer).  From one
definition tree come:

  * ``init_tree``      — materialised parameters, drawn from one
                         ``torch.Generator`` (the reference's distributions;
                         the bits differ from JAX's, so tests carry weights
                         across instead, ``checkpoint/convert.py``)
  * ``abstract_tree``  — meta-device tensors of the leaves' shapes and
                         dtypes (the dry run: no allocation, so it works for
                         the 398B configs)
  * ``axes_tree``      — each leaf's logical axes, which
                         ``distributed/sharding.py`` resolves to placements

Logical axis names: "embed" (d_model), "vocab", "heads", "kv_heads",
"head_dim", "mlp" (d_ff), "experts", "expert_mlp", "layers" (the stacked
repeat dim), "conv" (ssm conv width), "qkv" (the packed SSM projection) —
plus None for replicated dims.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["ParamDef", "init_tree", "abstract_tree", "axes_tree",
           "normal_init", "zeros_init", "ones_init", "scaled_init",
           "tree_leaves", "tree_map"]

#: An initialiser: (generator, shape, dtype, device) → tensor.
Init = Callable[[torch.Generator, Tuple[int, ...], torch.dtype,
                 torch.device], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis per dim
    dtype: Any = torch.bfloat16
    init: Init = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _normal(gen, shape, device, std: float) -> torch.Tensor:
    # scaled in place: the same values as ``* std`` without a second f32
    # copy of the leaf
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(std)


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


def init_tree(defs, seed: int, device, leaf_fn=None) -> Any:
    """Materialise a ParamDef tree on ``device``: one generator seeded with
    ``seed`` draws the leaves in ``tree_leaves`` order.  ``leaf_fn(path,
    tensor)``, when given, replaces each leaf as soon as it is drawn (the
    path a tuple of dict keys and list indices)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def walk(node, path):
        if isinstance(node, ParamDef):
            t = (node.init or normal_init())(gen, node.shape, node.dtype,
                                             device)
            return t if leaf_fn is None else leaf_fn(path, t)
        if isinstance(node, dict):
            # drawn in sorted key order, kept in the defs' order
            vals = {k: walk(node[k], path + (k,)) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,))
                              for i, v in enumerate(node))
        return None
    return walk(defs, ())


def _map_defs(fn, defs):
    """``fn`` over the ParamDef leaves of a defs tree, keeping its shape."""
    return tree_map(fn, defs, is_leaf=lambda d: isinstance(d, ParamDef))


def abstract_tree(defs):
    """Meta-device tensors of each leaf's shape and dtype: nothing is
    allocated (the dry run's parameters)."""
    return _map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                           device="meta"), defs)


def axes_tree(defs):
    """The logical-axes tree matching the parameter tree."""
    return _map_defs(lambda d: d.axes, defs)
