"""CurriculumSampler — which graphs does the policy see this episode?

Port of ``repro/core/train/sampler.py``, a numpy copy: the same seed draws
the same (bucket, graph ids) sequence in either package, and the state
dicts are interchangeable as JSON.  A corpus is bucketed by size
(``plan_buckets``); the sampler picks, per episode, a bucket and
``graphs_per_episode`` member graphs:

* ``uniform``    — bucket drawn ∝ member count (every graph equally
  likely), members uniform.
* ``stratified`` — buckets cycle round-robin (small graphs are never
  starved by a corpus dominated by one size class), members uniform.
* ``plateau``    — ``uniform``, but each graph carries a weight that decays
  while its best latency keeps improving and is boosted once it has not
  improved for ``plateau_patience`` sampled episodes — compute drains
  toward the graphs the policy is stuck on.

All randomness comes from one ``numpy.random.Generator``; the full state
(generator bit state + plateau statistics + episode counter) round-trips
through :meth:`state_dict` / :meth:`load_state_dict` as plain JSON, which
is what makes interrupted corpus runs resume *deterministically* — the
resumed run draws the exact graph sequence the uninterrupted run would
have.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CurriculumSampler"]

_STRATEGIES = ("uniform", "stratified", "plateau")


class CurriculumSampler:
    """See module docstring.  ``buckets`` is a partition of corpus indices
    (as returned by :func:`repro_torch.core.costmodel.plan_buckets`)."""

    def __init__(self, buckets: Sequence[Sequence[int]], *,
                 graphs_per_episode: int = 4, strategy: str = "stratified",
                 seed: int = 0, plateau_patience: int = 5,
                 plateau_boost: float = 4.0):
        if strategy not in _STRATEGIES:
            raise ValueError(f"unknown sampler strategy {strategy!r}; "
                             f"expected one of {_STRATEGIES}")
        if graphs_per_episode < 1:
            raise ValueError("graphs_per_episode must be >= 1")
        if not buckets or any(not b for b in buckets):
            raise ValueError("buckets must be non-empty index lists")
        self.buckets = [list(map(int, b)) for b in buckets]
        self.graphs_per_episode = int(graphs_per_episode)
        self.strategy = strategy
        self.plateau_patience = int(plateau_patience)
        self.plateau_boost = float(plateau_boost)
        self._rng = np.random.default_rng(seed)
        self._episode = 0
        n = 1 + max(max(b) for b in self.buckets)
        self._bucket_of = np.full(n, -1, np.int64)
        for bi, b in enumerate(self.buckets):
            self._bucket_of[b] = bi
        # plateau stats: per-graph best seen + episodes since improvement
        self._best = np.full(n, np.inf)
        self._stale = np.zeros(n, np.int64)

    # ---------------------------------------------------------------- sample
    def sample(self) -> Tuple[int, List[int]]:
        """→ (bucket index, graph indices) for the next episode.

        Members are drawn without replacement when the bucket is large
        enough, with replacement otherwise (an episode always has
        ``graphs_per_episode`` slots, so small buckets repeat members rather
        than shrink).
        """
        k = self.graphs_per_episode
        if self.strategy == "stratified":
            bi = self._episode % len(self.buckets)
        else:
            counts = np.asarray([len(b) for b in self.buckets], float)
            if self.strategy == "plateau":
                counts = np.asarray(
                    [sum(self._weight(i) for i in b) for b in self.buckets])
            bi = int(self._rng.choice(len(self.buckets),
                                      p=counts / counts.sum()))
        members = self.buckets[bi]
        if self.strategy == "plateau":
            w = np.asarray([self._weight(i) for i in members])
            p = w / w.sum()
        else:
            p = None
        ids = self._rng.choice(members, size=k,
                               replace=len(members) < k, p=p)
        self._episode += 1
        return bi, [int(i) for i in ids]

    def peek(self) -> Tuple[int, List[int]]:
        """Predict the next :meth:`sample` without consuming it.

        Runs the real draw, then restores the generator bit state and the
        episode counter — so for ``uniform``/``stratified`` (whose draws
        depend on RNG state alone; :meth:`observe` consumes no randomness)
        the prediction is *exact*.  Under ``plateau`` an ``observe`` between
        peek and draw may re-weight graphs and mispredict — the episode
        prefetcher treats that as a cache miss and rebuilds synchronously.
        """
        state = self._rng.bit_generator.state
        episode = self._episode
        try:
            return self.sample()
        finally:
            self._rng.bit_generator.state = state
            self._episode = episode

    def _weight(self, gid: int) -> float:
        return (self.plateau_boost
                if self._stale[gid] >= self.plateau_patience else 1.0)

    # --------------------------------------------------------------- observe
    def observe(self, graph_ids: Sequence[int],
                best_latencies: Sequence[float]) -> None:
        """Feed back the post-episode per-corpus-graph best latencies for
        the sampled graphs (drives the ``plateau`` strategy; a no-op signal
        for the others, but always tracked so strategies can be switched
        on resume)."""
        for gid in set(int(g) for g in graph_ids):
            lat = float(best_latencies[gid])
            if lat < self._best[gid] - 1e-12:
                self._best[gid] = lat
                self._stale[gid] = 0
            else:
                self._stale[gid] += 1

    # ------------------------------------------------------------ checkpoint
    def state_dict(self) -> Dict:
        """JSON-serializable full state (recorded in checkpoint manifests)."""
        return {
            "episode": int(self._episode),
            "rng": self._rng.bit_generator.state,
            "best": [None if not np.isfinite(v) else float(v)
                     for v in self._best],
            "stale": [int(v) for v in self._stale],
            "strategy": self.strategy,
            "graphs_per_episode": self.graphs_per_episode,
            "buckets": [list(b) for b in self.buckets],
        }

    def load_state_dict(self, state: Dict) -> None:
        if [list(b) for b in self.buckets] != \
                [list(map(int, b)) for b in state["buckets"]]:
            raise ValueError(
                "sampler state was saved for a different bucket partition — "
                "the corpus (or max_buckets) changed since the checkpoint")
        self._episode = int(state["episode"])
        self._rng.bit_generator.state = state["rng"]
        self._best = np.asarray([np.inf if v is None else float(v)
                                 for v in state["best"]])
        self._stale = np.asarray([int(v) for v in state["stale"]], np.int64)
