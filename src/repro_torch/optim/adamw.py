"""Adam (paper §2.5 trains with Adam [13]) — PyTorch.

Port of ``repro/optim/adamw.py::adam``: the same moments, bias corrections
and update, term for term in float32, so one step from the same state lands
on the reference's parameters.  The state crosses to and from the
reference's ``OptState(step, mu, nu)`` as a tree (:meth:`Adam.state_tree`),
which is how a corpus checkpoint of either package carries it.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np
import torch

__all__ = ["Adam"]


class Adam:
    """Adam over a fixed list of parameter tensors, updated in place."""

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: float,
                 *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.step = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """One step with ``grads`` (one per parameter, in order)."""
        self.step += 1
        # Bias corrections in float32, as the reference computes them.
        step = np.float32(self.step)
        b1c = float(np.float32(1.0) - np.float32(self.b1) ** step)
        b2c = float(np.float32(1.0) - np.float32(self.b2) ** step)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g * g)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            p.copy_(p + (-self.learning_rate) * delta)

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
