"""Learning-rate schedules (pure functions of the step).

Port of ``repro/optim/schedules.py``.  Each schedule maps an integer step
(a Python int, a numpy integer or a 0-d tensor) to the learning rate as a
numpy float32, computed step by step in float32 as the reference's ``jnp``
arithmetic does (every Python constant rounded to float32 where the
reference's weakly typed scalars are).  The cosine is the float64 cosine
of the float32 angle rounded to float32, the nearest a float32 ``cos`` can
be: XLA's float32 ``cos`` is that value at every step of the launcher's
decay tested (numpy's and PyTorch's float32 ``cos`` are an ulp off at
some), and ``1 + cos`` near the end of the decay would turn one ulp of the
cosine into several of the rate.
"""
from __future__ import annotations

import numpy as np

__all__ = ["constant", "cosine_decay", "linear_warmup_cosine"]

_f32 = np.float32


def _step(step) -> np.float32:
    return _f32(int(step))


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def schedule(step):
        t = np.clip(_step(step) / _f32(decay_steps), _f32(0.0), _f32(1.0))
        angle = _f32(np.pi) * t
        cos = _f32(0.5) * (_f32(1.0) + _f32(np.cos(np.float64(angle))))
        return _f32(lr) * (_f32(1 - alpha) * cos + _f32(alpha))
    return schedule


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         alpha: float = 0.1):
    cos = cosine_decay(lr, max(1, total_steps - warmup_steps), alpha)

    def schedule(step):
        s = _step(step)
        if s < _f32(warmup_steps):
            return _f32(lr) * s / _f32(max(1, warmup_steps))
        return cos(int(step) - warmup_steps)
    return schedule
