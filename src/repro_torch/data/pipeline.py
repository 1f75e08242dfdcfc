"""Deterministic, resumable synthetic token pipeline.

Port of ``repro/data/pipeline.py``.  Every batch is a pure function of
(seed, step): restart-from-checkpoint replays the exact same stream, and the
port's batches are the reference's bit for bit (the same numpy generators
draw them).  ``_gen(step, lo, hi)`` makes rows [lo, hi) of a step's global
batch, so a rank can make only its own rows; the reference's sharded
callback (``jax.make_array_from_callback``) waits for ``launch/mesh``.

The stream is a Zipf-ish unigram mixture with short-range repetition, so tiny
LMs have real structure to learn in examples (loss visibly decreases).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

__all__ = ["DataConfig", "SyntheticTokens"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2            # unigram skew
    repeat_p: float = 0.35         # P(copy a recent token) — learnable signal
    repeat_window: int = 8


class SyntheticTokens:
    """Step-indexed batch source: ``batch(step)`` → {"tokens", "labels"},
    int32 (global_batch, seq_len) tensors on ``device``."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # Zipf unigram distribution (renormalized, capped for tiny vocabs)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()

    def _gen(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the global batch for ``step`` (host-shardable)."""
        cfg = self.cfg
        out = np.empty((hi - lo, cfg.seq_len + 1), dtype=np.int32)
        for r in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, r]))
            seq = rng.choice(cfg.vocab_size, size=cfg.seq_len + 1,
                             p=self._probs).astype(np.int32)
            # short-range repetition: predictable structure
            rep = rng.random(cfg.seq_len + 1) < cfg.repeat_p
            back = rng.integers(1, cfg.repeat_window, cfg.seq_len + 1)
            for t in range(1, cfg.seq_len + 1):
                if rep[t]:
                    seq[t] = seq[max(0, t - back[t])]
            out[r - lo] = seq
        return out

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        raw = torch.from_numpy(self._gen(step, 0, self.cfg.global_batch))
        return {"tokens": raw[:, :-1].contiguous().to(self.device),
                "labels": raw[:, 1:].contiguous().to(self.device)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
