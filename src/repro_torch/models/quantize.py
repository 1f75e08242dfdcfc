"""Weight-only int8 quantization for serving.

Port of ``repro/models/quantize.py``: matrix weights stored as int8 with
per-output-channel f32 scales, which halves the resident and read bytes of
a bf16 model.  ``QTensor`` is a NamedTuple, so a quantized leaf rides
through the port's tree helpers (``params.tree_map``, ``tree_leaves``) as
the reference's pytree node does.

The values are bitwise the reference's: the same f32 arithmetic
(``amax / 127``, ``w / scale``, round half to even, clip), and the maxima
are exact in any order.  What differs is memory: eager PyTorch
materialises what XLA fuses, so ``quantize_tensor`` and ``dequantize`` walk
a weight in slabs of at most ``SLAB`` elements along its leading axes (an
expert's slice of a stacked MoE weight, or less), and the f32 copy of a
whole leaf never exists.  ``models/lm.py`` dequantizes one block position
of one repeat at a time, and ``init_quantized_params`` quantizes each leaf
as it is drawn, so neither a bf16 tree nor a whole repeat's bf16 copy is
ever resident.

Which leaves are quantized follows the reference's rule on its tree-path
strings (``"['blocks']/[0]/['ffn']/['w_gate']"``): floating leaves of two
or more dims whose path names no norm, ``a_log``, ``dt_bias``, ``d_skip``,
``conv_b`` or ``slot_pos``; the port spells its paths the same way.
"""
from __future__ import annotations

from typing import Any, Iterator, NamedTuple, Tuple

import torch

from ..kernels._work import is_dtensor
from .config import ModelConfig

__all__ = ["QTensor", "quantize_tensor", "dequantize", "quantize_params",
           "abstract_quantized", "quantize_spec_tree", "dequant_tree",
           "quantized_paths", "init_quantized_params", "SLAB"]

#: the most elements ``quantize_tensor`` and ``dequantize`` convert to f32
#: at once (256 MiB of f32)
SLAB = 1 << 26

_SKIP = ("norm", "a_log", "dt_bias", "d_skip", "conv_b", "slot_pos")


class QTensor(NamedTuple):
    data: torch.Tensor       # int8, same shape as the original weight
    scale: torch.Tensor      # f32, per output channel (last dim)


def _slabs(rows: int, row_elems: int) -> Iterator[slice]:
    """Slices of ``rows`` whose elements (``row_elems`` a row) stay within
    ``SLAB``, at least one row each."""
    step = max(1, SLAB // max(1, row_elems))
    for r0 in range(0, rows, step):
        yield slice(r0, min(rows, r0 + step))


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """Symmetric per-output-channel int8 quantization.

    Scales keep the FIRST dim for stacked (layers, …) weights and the last
    (output-channel) dim: ndim ≥ 3 → scale (first, last), the maximum over
    dims 1..ndim−2; ndim == 2 → scale (last,), the maximum over dim 0 (the
    reference's rule, also for a stacked 2-D leaf)."""
    a = w.shape[0] if w.ndim >= 3 else 1
    last = w.shape[-1]
    w3 = w.reshape(a, -1, last)                 # (first, reduced, last)
    m = w3.shape[1]
    amax = torch.zeros(a, 1, last, dtype=torch.float32, device=w.device)
    for sl in _slabs(m, a * last):
        part = w3[:, sl].to(torch.float32).abs().amax(1, keepdim=True)
        torch.maximum(amax, part, out=amax)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.empty(w3.shape, dtype=torch.int8, device=w.device)
    for sl in _slabs(m, a * last):
        q[:, sl] = torch.round(w3[:, sl].to(torch.float32) / scale) \
            .clamp_(-127, 127).to(torch.int8)
    return QTensor(q.view(w.shape),
                   scale.reshape((a, last) if w.ndim >= 3 else (last,)))


def dequantize(x: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """A QTensor as ``dtype`` (an f32 multiply by its scale, then the cast);
    anything else as it is."""
    if not isinstance(x, QTensor):
        return x
    data, scale = x.data, x.scale
    last = data.shape[-1]
    if scale.ndim == 2 and data.ndim >= 3:
        a = scale.shape[0]                      # (first, last)
    elif scale.ndim == 1:
        a = 1                                   # (last,)
    else:
        raise ValueError(f"dequantize: scale {tuple(scale.shape)} does not "
                         f"fit data {tuple(data.shape)}")
    d3 = data.reshape(a, -1, last)
    s3 = scale.reshape(a, 1, last)
    if is_dtensor(data):
        # the dry run's int8 tree: one elementwise pass over the shards
        return (d3.to(torch.float32) * s3).to(dtype).view(data.shape)
    out = torch.empty(d3.shape, dtype=dtype, device=data.device)
    for sl in _slabs(d3.shape[1], a * last):
        out[:, sl] = (d3[:, sl].to(torch.float32) * s3).to(dtype)
    return out.view(data.shape)


def _key(part) -> str:
    """One step of a tree path as ``jax.tree_util`` prints it."""
    return f"[{part}]" if isinstance(part, int) else f"['{part}']"


def _path(parts: Tuple) -> str:
    return "/".join(_key(p) for p in parts)


def _should_quantize(path: str, shape, dtype) -> bool:
    # matrix weights only; skip norms/biases/scalars and anything non-float
    if len(shape) < 2 or dtype not in (torch.bfloat16, torch.float32):
        return False
    return not any(s in path for s in _SKIP)


def _map(fn, tree, parts: Tuple = ()):
    """``fn(path string, leaf)`` over a dict/list tree of tensors."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, parts + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, QTensor):
        return type(tree)(_map(fn, v, parts + (i,))
                          for i, v in enumerate(tree))
    return fn(_path(parts), tree)


def quantized_paths(params: dict) -> Tuple[str, ...]:
    """The tree paths (the reference's spelling) of the leaves
    ``quantize_params`` quantizes, sorted."""
    found = []

    def visit(path, leaf):
        if isinstance(leaf, torch.Tensor) and _should_quantize(
                path, leaf.shape, leaf.dtype):
            found.append(path)
        return leaf
    _map(visit, params)
    return tuple(sorted(found))


def quantize_params(params: dict, cfg: ModelConfig) -> dict:
    """Quantize the block weights + lm_head/embed of a param tree."""
    def leaf(path, w):
        if isinstance(w, torch.Tensor) and _should_quantize(path, w.shape,
                                                            w.dtype):
            return quantize_tensor(w)
        return w
    return _map(leaf, params)


def _scale_shape(shape) -> Tuple[int, ...]:
    """A quantized leaf's per-channel scale: (layers, out) for a stacked
    weight (ndim >= 3), else (out,)."""
    return (shape[0], shape[-1]) if len(shape) >= 3 else (shape[-1],)


def abstract_quantized(abs_params: dict) -> dict:
    """The tree ``quantize_params`` makes of ``abs_params`` (meta tensors),
    as meta tensors of its shapes and dtypes, without computing it: the
    dry run's int8 parameters."""
    def leaf(path, t):
        if isinstance(t, torch.Tensor) and _should_quantize(path, t.shape,
                                                            t.dtype):
            return QTensor(torch.empty(t.shape, dtype=torch.int8,
                                       device="meta"),
                           torch.empty(_scale_shape(t.shape),
                                       dtype=torch.float32, device="meta"))
        return t
    return _map(leaf, abs_params)


def quantize_spec_tree(abs_params: dict, spec_tree: dict, mesh=None) -> dict:
    """Layouts of a quantized parameter tree: ``spec_tree`` holds each
    leaf's resolved spec (a tuple of mesh axes per dim,
    ``distributed.sharding.spec_tree``); a leaf ``quantize_params``
    quantizes becomes ``QTensor(data spec, scale spec)``: the data keeps
    the leaf's spec, the per-channel scale takes its first and last
    entries for ndim >= 3 (a stacked weight's (layers, out) scales), else
    the last.  ``mesh`` is accepted for the reference's signature; the
    specs are already resolved on it."""
    def walk(node, specs, parts):
        if isinstance(node, dict):
            return {k: walk(v, specs[k], parts + (k,))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, sp, parts + (i,))
                              for i, (v, sp) in enumerate(zip(node, specs)))
        if isinstance(node, torch.Tensor) and _should_quantize(
                _path(parts), node.shape, node.dtype):
            sp = tuple(specs)
            scale = ((sp[0] if sp else None, sp[-1] if sp else None)
                     if node.ndim >= 3 else (sp[-1] if sp else None,))
            return QTensor(sp, scale)
        return specs
    return walk(abs_params, spec_tree, ())


def dequant_tree(tree: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Dequantize every QTensor in a (sub)tree."""
    if isinstance(tree, QTensor):
        return dequantize(tree, dtype)
    if isinstance(tree, dict):
        return {k: dequant_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [dequant_tree(v, dtype) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return tree


def init_quantized_params(cfg: ModelConfig, seed: int = 0,
                          device="cuda") -> dict:
    """``quantize_params(init_params(cfg, seed, device), cfg)``, bit for
    bit, built leaf by leaf: each leaf is drawn in ``init_params``' order
    from the same generator and quantized at once, and its bf16 copy
    dropped, so the whole unquantized tree is never resident."""
    from .lm import model_defs
    from .params import init_tree

    def leaf(parts, w):
        path = _path(parts)
        return quantize_tensor(w) if _should_quantize(
            path, w.shape, w.dtype) else w
    return init_tree(model_defs(cfg), seed, device, leaf_fn=leaf)
