"""Adam (paper §2.5 trains with Adam [13]) — PyTorch.

Port of ``repro/optim/adamw.py::adam``: the same moments, bias corrections
and update, term for term in float32, so one step from the same state lands
on the reference's parameters.
"""
from __future__ import annotations

from typing import Iterable, Sequence

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
