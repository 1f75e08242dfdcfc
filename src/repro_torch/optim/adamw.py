"""Adam and AdamW — PyTorch.

Port of ``repro/optim/adamw.py`` in two forms:

* the functional ``adamw`` / ``adam`` (a :class:`GradientTransform` of
  ``init`` and ``update`` over the LM's dict/list parameter trees) with
  ``OptState(step, mu, nu)`` and ``apply_updates``, which the LM train step
  uses.  The dtype rules are the reference's: moments start in
  ``state_dtype or p.dtype``, take ``state_dtype or g.dtype`` after each
  update (so float32 gradients, as grad accumulation gives, turn a bf16
  model's moments to float32), the bias corrections are ``1 - b ** step``
  in float32 and each update is cast to its parameter's dtype;
* the ``Adam`` class the placement policy trains with: the functional
  ``adam``'s update over a fixed list of tensors, written back in place
  (the reference's policy and LM share one ``adam`` too).  Its state
  crosses to and from the
  reference's ``OptState`` as a tree (:meth:`Adam.state_tree`), which is how
  a corpus checkpoint of either package carries it.

Every step of the functional update is the reference's float32 arithmetic
with the same operand order, so one step from the same state and gradients
lands on the reference's parameters up to the rounding of ``pow`` and
``sqrt``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, \
    Sequence

import numpy as np
import torch

__all__ = ["Adam", "adam", "adamw", "GradientTransform", "OptState",
           "apply_updates"]

PyTree = Any


class OptState(NamedTuple):
    step: torch.Tensor     # () int32, on the CPU
    mu: PyTree             # first moment
    nu: PyTree             # second moment


@dataclasses.dataclass(frozen=True)
class GradientTransform:
    init: Callable[[PyTree], OptState]
    update: Callable[..., tuple]


def _map(fn, *trees):
    """``fn`` over the leaves of dict/list/tuple trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _pick(tree, i: int):
    """The ``i``-th entry of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def adamw(learning_rate, *, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          state_dtype: Optional[torch.dtype] = None) -> GradientTransform:
    """AdamW.  ``learning_rate`` may be a float or a step → lr callable
    (``optim.schedules``)."""

    def lr_at(step: int) -> float:
        lr = learning_rate(step) if callable(learning_rate) \
            else learning_rate
        return float(np.float32(lr))

    def init(params: PyTree) -> OptState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=state_dtype or p.dtype,
                               device=p.device)
        return OptState(torch.zeros((), dtype=torch.int32),
                        _map(zeros, params), _map(zeros, params))

    @torch.no_grad()
    def update(grads: PyTree, state: OptState,
               params: Optional[PyTree] = None):
        step = int(state.step) + 1
        f32 = np.float32
        b1c = float(f32(1.0) - f32(b1) ** f32(step))
        b2c = float(f32(1.0) - f32(b2) ** f32(step))
        neg_lr = -lr_at(step)

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m = b1 * m.to(torch.float32) + (1 - b1) * g32
            v = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
            delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
            if weight_decay and p is not None:
                delta = delta + weight_decay * p.to(torch.float32)
            dt = state_dtype or g.dtype
            out = (neg_lr * delta).to(p.dtype if p is not None else g.dtype)
            return out, m.to(dt), v.to(dt)

        p_tree = params if params is not None else grads
        flat = _map(upd, grads, state.mu, state.nu, p_tree)
        return _pick(flat, 0), OptState(
            torch.tensor(step, dtype=torch.int32), _pick(flat, 1),
            _pick(flat, 2))

    return GradientTransform(init, update)


def adam(learning_rate, **kw) -> GradientTransform:
    """Plain Adam (the paper's optimizer): AdamW with zero decay."""
    kw.pop("weight_decay", None)
    return adamw(learning_rate, weight_decay=0.0, **kw)


@torch.no_grad()
def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return _map(lambda p, u: p + u.to(p.dtype), params, updates)


class Adam:
    """Adam over a fixed list of parameter tensors, updated in place."""

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: float,
                 *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.learning_rate = learning_rate
        self._tx = adam(learning_rate, b1=b1, b2=b2, eps=eps)
        self.step = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """One step with ``grads`` (one per parameter, in order): the
        functional ``adam``'s update, written back in place."""
        state = OptState(torch.tensor(self.step, dtype=torch.int32),
                         self.mu, self.nu)
        updates, new = self._tx.update(list(grads), state, self.params)
        for p, u, m, v, m2, v2 in zip(self.params, updates, self.mu,
                                      self.nu, new.mu, new.nu):
            p.copy_(p + u)
            m.copy_(m2)
            v.copy_(v2)
        self.step += 1

    def state_tree(self, names: Sequence[str]) -> Dict:
        """The reference's ``OptState`` as a tree: ``{"step": int32 (),
        "mu": tree, "nu": tree}``, the moments under the reference's
        parameter paths and layouts; ``names`` are the parameters' names in
        order (``policy.named_parameters()``)."""
        from ..checkpoint.convert import tree_from_tensors
        return {"step": np.asarray(self.step, np.int32),
                "mu": tree_from_tensors(names, self.mu),
                "nu": tree_from_tensors(names, self.nu)}

    @torch.no_grad()
    def load_state_tree(self, tree: Dict, names: Sequence[str]) -> None:
        """Adopt a :meth:`state_tree` of either package (the moments
        bitwise)."""
        from ..checkpoint.convert import tensors_from_tree
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            for t, arr in zip(dst, tensors_from_tree(names, tree[key])):
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"optimizer state {key}: shape "
                                     f"{arr.shape} does not fit "
                                     f"{tuple(t.shape)}")
                t.copy_(torch.from_numpy(arr))
        self.step = int(np.asarray(tree["step"]))
