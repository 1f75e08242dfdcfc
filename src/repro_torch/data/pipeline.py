"""Deterministic, resumable synthetic token pipeline.

Port of ``repro/data/pipeline.py``.  Every batch is a pure function of
(seed, step): restart-from-checkpoint replays the exact same stream, and the
port's batches are the reference's bit for bit (the same numpy generators
draw them).  ``_gen(step, lo, hi)`` makes rows [lo, hi) of a step's global
batch.  With a mesh, each rank makes only its own rows and columns and the
batch is a DTensor laid out by ``placements`` (default: rows sharded as the
logical "batch" axis says): the counterpart of the reference's
``jax.make_array_from_callback``.

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
    int32 (global_batch, seq_len) tensors on ``device``; with ``mesh``,
    DTensors of that global shape whose local rows each rank made itself."""

    def __init__(self, cfg: DataConfig, device="cuda", mesh=None,
                 placements=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None and placements is None:
            from ..distributed.sharding import logical_spec, placements_for
            placements = placements_for(
                logical_spec(("batch", "act_seq"), None, mesh), mesh)
        self.placements = placements
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

    def local_slices(self):
        """This rank's (rows, columns) of the global (batch, seq) under the
        mesh's placements: even splits, mesh dims in order."""
        from torch.distributed.tensor import Shard
        bounds = [[0, self.cfg.global_batch], [0, self.cfg.seq_len]]
        for i, p in enumerate(self.placements):
            if isinstance(p, Shard):
                lo, hi = bounds[p.dim]
                size = self.mesh.size(i)
                if (hi - lo) % size:
                    raise ValueError(f"SyntheticTokens: {hi - lo} along dim "
                                     f"{p.dim} do not split evenly over "
                                     f"{size} ranks")
                n = (hi - lo) // size
                lo += self.mesh.get_local_rank(i) * n
                bounds[p.dim] = [lo, lo + n]
        return slice(*bounds[0]), slice(*bounds[1])

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        if self.mesh is None:
            raw = torch.from_numpy(self._gen(step, 0, self.cfg.global_batch))
            return {"tokens": raw[:, :-1].contiguous().to(self.device),
                    "labels": raw[:, 1:].contiguous().to(self.device)}
        from torch.distributed.tensor import DTensor
        rows, cols = self.local_slices()
        raw = torch.from_numpy(self._gen(step, rows.start, rows.stop))
        shape = (self.cfg.global_batch, self.cfg.seq_len)
        out = {}
        for key, part in (("tokens", raw[:, :-1]), ("labels", raw[:, 1:])):
            local = part[:, cols].contiguous().to(self.device)
            out[key] = DTensor.from_local(local, self.mesh, self.placements,
                                          run_check=False, shape=shape,
                                          stride=(shape[1], 1))
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
