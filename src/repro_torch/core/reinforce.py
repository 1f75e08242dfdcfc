"""REINFORCE machinery (paper §2.5, Eq. 12–14).

The paper stores ``update_timestep`` steps in a buffer and updates with

    ∇J(θ) ≈ − Σ_{i=1..x} ∇ log p(P_i | G'; θ) · γ^i · r(P_i, G)      (Eq. 14)

i.e. each step's log-probability is weighted by its *own* discounted reward
(not a summed return).  ``step_weights`` implements that faithfully; the
beyond-paper variance-reduction options (reward-to-go, moving-average
baseline, reward normalization) are opt-in flags recorded in EXPERIMENTS.md.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["step_weights", "RunningBaseline"]


def step_weights(rewards: np.ndarray, gamma: float, *,
                 reward_to_go: bool = False,
                 baseline: Optional[float] = None,
                 normalize: bool = False) -> np.ndarray:
    """Per-step loss weights w_i so that loss = −Σ_i w_i · log p(P_i).

    ``rewards`` may be (T,) — one chain — or (B, T): any leading batch axes
    are carried through elementwise; **time is the last axis**.  Default
    (paper Eq. 14): w_i = γ^i · r_i  (i zero-based here; the constant γ offset
    between 1-based and 0-based indexing is absorbed by the learning rate).
    Options:
      * ``reward_to_go``: w_i = Σ_{j≥i} γ^{j−i} r_j (classic REINFORCE return)
      * ``baseline``: subtract a scalar baseline from rewards first
      * ``normalize``: standardize the weights per chain (variance reduction)
    """
    r = np.asarray(rewards, dtype=np.float64)
    if baseline is not None:
        r = r - float(baseline)
    x = r.shape[-1]
    if reward_to_go:
        w = np.zeros_like(r)
        acc = np.zeros(r.shape[:-1])
        for i in range(x - 1, -1, -1):
            acc = r[..., i] + gamma * acc
            w[..., i] = acc
    else:
        w = (gamma ** np.arange(x)) * r
    if normalize and x > 1:
        std = w.std(axis=-1, keepdims=True)
        safe = np.where(std > 1e-12, std, 1.0)
        w = np.where(std > 1e-12, (w - w.mean(axis=-1, keepdims=True)) / safe,
                     w)
    return w.astype(np.float32)


class RunningBaseline:
    """Exponential-moving-average reward baseline (beyond-paper, opt-in)."""

    def __init__(self, beta: float = 0.9):
        self.beta = beta
        self.value: Optional[float] = None

    def update(self, reward: float) -> float:
        if self.value is None:
            self.value = float(reward)
        else:
            self.value = self.beta * self.value + (1 - self.beta) * float(reward)
        return self.value
