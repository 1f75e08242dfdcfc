"""PlacementService — a long-lived, warm placement server, PyTorch port.

Port of ``repro/api/service.py``, with its constructor, errors, counters
and ``stats()`` keys.  A fitted :class:`~repro_torch.api.PlacementSession`
can ``place()`` any graph, but each call re-extracts features and rebuilds
the graph's device inputs.  The service keeps them warm:

* **Prepared-graph LRU** — keyed by content fingerprint
  (``corpus_fingerprint([graph])``), an entry holds the graph's
  :class:`~repro_torch.core.GraphArrays` and its
  :class:`~repro_torch.core.sim.rollout.RolloutEngine` (features and CSR
  already on the device), so a repeat request featurises, builds and
  uploads nothing (``cache_hits``/``cache_misses`` count it).
* **Buckets** — request shapes round up to ``size_granularity`` multiples
  (nodes and edges), as in the reference, whose jit cache keys on them.
  The port compiles nothing per shape, so a bucket only names a batch and
  an AOT key: ``shape_keys_seen`` is the set of buckets this process
  decoded cold (without a preloaded blob).  On the same stream its size is
  the reference's count of traced shapes.
* **Persistent AOT cache** — with ``aot_cache=`` set, the first cold decode
  of each bucket stores a blob keyed by ``(spec_hash, bucket shape,
  batch_slots)``; a fresh process serving that bucket preloads it and has
  no cold bucket (``aot_decodes`` counts decodes of a preloaded bucket).
  See ``api/aot.py`` for what the port's blob holds and saves.
* **Batched decode** — :meth:`place_many` groups a burst by bucket and
  decodes ``batch_slots`` requests a chunk.  The reference pads a short
  chunk with repeats because the chunk width is part of its jit key; the
  port has no such key and decodes a chunk's members only, each its own
  greedy decode through one ``MultiRolloutEngine`` (``requests`` counts the
  members, as the reference's does).

Failure isolation is the reference's: requests are validated (featurised)
one at a time, and a bad graph fails its own request only.
``place_many(..., return_exceptions=True)`` returns the exception in that
request's slot and serves the rest; the default raises
:class:`PlacementRequestError` naming every offending graph before any
decode or request counter moves.

Decoding an unpadded graph is what ``PlacementSession.place`` does, so the
service's placements are the session's exactly.  The service runs on its
session's device; a checkpoint path is loaded on ``device``, the card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.costmodel import simulate
from ..core.features import GraphArrays
from ..core.graph import CompGraph
from ..core.sim.rollout import MultiRolloutEngine, RolloutEngine
from ..graphs.workloads import corpus_fingerprint
from .aot import AotExecutableCache, greedy_blob, preload_greedy
from .session import PlacementSession

__all__ = ["PlacementService", "PlacementRequestError"]


def _round_up(n: int, granularity: int) -> int:
    return max(granularity, ((int(n) + granularity - 1) // granularity)
               * granularity)


class PlacementRequestError(ValueError):
    """A burst contained invalid requests; names each offending graph.

    ``failures`` maps request index → the underlying exception, so a
    caller that wants partial results can retry with
    ``return_exceptions=True`` instead.
    """

    def __init__(self, failures: Dict[int, Exception],
                 names: Dict[int, str]):
        self.failures = dict(failures)
        detail = "; ".join(
            f"request {i} ({names.get(i, '?')!r}): {failures[i]}"
            for i in sorted(failures))
        super().__init__(
            f"{len(failures)} invalid request(s) in burst — {detail}")


class Prepared:
    """One LRU entry: a graph's arrays and its decode engine (device
    inputs built)."""

    __slots__ = ("arrays", "engine")

    def __init__(self, arrays: GraphArrays, engine: RolloutEngine):
        self.arrays = arrays
        self.engine = engine


class PlacementService:
    """See module docstring.  Example::

        service = PlacementService("ckpt/corpus_policy",  # or a session
                                   aot_cache="ckpt/aot")  # optional, persists
        placement = service.place(graph)                  # warm after 1st
        placements = service.place_many(burst_of_graphs)  # batched decode
        service.stats()   # hits/misses/cold buckets/AOT counters
    """

    def __init__(self, session: Union[PlacementSession, str], *,
                 cache_size: int = 64, batch_slots: int = 4,
                 size_granularity: int = 16,
                 aot_cache: Union[AotExecutableCache, str, None] = None,
                 device="cuda"):
        if isinstance(session, str):
            session = PlacementSession.load(session, device=device)
        session._require_fit()
        if session.feature_config is None:
            raise ValueError("session carries no feature layout — the "
                             "service cannot featurize requests")
        if batch_slots < 1 or cache_size < 1 or size_granularity < 1:
            raise ValueError("batch_slots, cache_size and size_granularity "
                             "must all be >= 1")
        self.session = session
        self.device = session.device
        self.batch_slots = int(batch_slots)
        self.size_granularity = int(size_granularity)
        self._cache_size = int(cache_size)
        self._prepared_lru: "OrderedDict[str, Prepared]" = OrderedDict()
        if isinstance(aot_cache, str):
            aot_cache = AotExecutableCache(aot_cache)
        self._aot = aot_cache
        self._spec_hash = (session.spec.spec_hash()
                           if session.spec is not None else None)
        # buckets whose blob was already looked up / stored (once per
        # process each), and those whose blob loaded
        self._aot_checked: set = set()
        self._aot_loaded: set = set()
        self._aot_stored: set = set()
        #: buckets decoded cold (no preloaded blob): the reference's traces
        self.shape_keys_seen: set = set()
        #: chunk decodes of a bucket whose blob was preloaded
        self.aot_decodes = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.requests = 0
        self.failed = 0

    # ------------------------------------------------------------- prep LRU
    def _prepared(self, graph: CompGraph) -> Prepared:
        key = corpus_fingerprint([graph])
        entry = self._prepared_lru.get(key)
        if entry is not None:
            self.cache_hits += 1
            self._prepared_lru.move_to_end(key)
            return entry
        arrays = self.session.featurize(graph)   # may raise: count after
        entry = Prepared(arrays, self.session.trainer.rollout_engine(arrays))
        self.cache_misses += 1
        self._prepared_lru[key] = entry
        while len(self._prepared_lru) > self._cache_size:
            self._prepared_lru.popitem(last=False)
        return entry

    def _bucket_shape(self, arrays: GraphArrays) -> Tuple[int, int]:
        g = self.size_granularity
        return (_round_up(arrays.num_nodes, g),
                _round_up(max(1, arrays.edges.shape[0]), g))

    def _engine(self, entry: Prepared) -> RolloutEngine:
        """The entry's engine on the session's current policy (a refit or
        a ``load_params`` replaces the policy object)."""
        trainer = self.session.trainer
        if entry.engine.policy is not trainer.policy:
            entry.engine = trainer._engine_on(entry.engine.x0,
                                              entry.engine.graph)
        return entry.engine

    # ----------------------------------------------------------- AOT plumbing
    def _aot_preload(self, bucket: Tuple[int, int]) -> None:
        """Try once per bucket to preload the stored blob."""
        if self._aot is None or bucket in self._aot_checked:
            return
        self._aot_checked.add(bucket)
        if self._spec_hash is None:
            return
        blob = self._aot.load(self._spec_hash, bucket, self.batch_slots)
        if blob is None:
            return
        try:
            preload_greedy(blob, self._spec_hash, bucket, self.batch_slots,
                           self.device)
            self._aot_loaded.add(bucket)
        except (ValueError, OSError):
            # another torch, card or kernel build, or a corrupt blob:
            # decode cold; the store below overwrites the bad entry
            self._aot.note_load_failure()

    def _aot_export(self, bucket: Tuple[int, int]) -> None:
        """Persist the bucket's blob after its first cold decode."""
        if (self._aot is None or self._spec_hash is None
                or bucket in self._aot_stored or bucket in self._aot_loaded):
            return
        self._aot_stored.add(bucket)
        self._aot.store(self._spec_hash, bucket, self.batch_slots,
                        greedy_blob(self._spec_hash, bucket,
                                    self.batch_slots, self.device))

    # --------------------------------------------------------------- serving
    def place(self, graph: CompGraph) -> np.ndarray:
        """Greedy-decode one placement (warm path: nothing rebuilt)."""
        return self.place_many([graph])[0]

    def evaluate(self, graph: CompGraph) -> Tuple[np.ndarray, float]:
        """→ (placement, simulated latency) on the session platform."""
        p = self.place(graph)
        return p, simulate(graph, p, self.session.platform).latency

    def decode_bucket(self, bucket: Tuple[int, int],
                      members: Sequence[Tuple[int, Prepared]],
                      out: List) -> None:
        """Decode same-bucket ``(slot_index, prepared)`` members into
        ``out``, ``batch_slots`` a chunk.

        The one device-facing hot path, shared by :meth:`place_many` and
        the async server's flusher.
        """
        self._aot_preload(bucket)
        for lo in range(0, len(members), self.batch_slots):
            chunk = members[lo:lo + self.batch_slots]
            engine = MultiRolloutEngine([self._engine(p) for _, p in chunk])
            fines = engine.greedy_decode()
            flat = torch.cat(fines).cpu().numpy().astype(np.int64)
            for (i, _), part in zip(chunk, np.split(
                    flat, np.cumsum(engine.num_nodes)[:-1])):
                out[i] = part
            if bucket in self._aot_loaded:
                self.aot_decodes += 1
            else:
                self.shape_keys_seen.add(bucket)
            self._aot_export(bucket)
            self.requests += len(chunk)

    def place_many(self, graphs: Sequence[CompGraph], *,
                   return_exceptions: bool = False) -> List:
        """Batch a burst of requests into per-bucket chunk decodes.

        Requests are grouped by bucket shape and decoded ``batch_slots`` at
        a time; response order matches the request order.  A request that
        fails validation (e.g. out-of-vocabulary ops) fails alone: with
        ``return_exceptions=True`` its slot holds the exception and every
        valid request is still served; with the default ``False`` the whole
        burst raises :class:`PlacementRequestError` *before* any decode, so
        counters stay consistent (``requests`` only ever counts decoded
        requests, ``failed`` counts rejected ones).
        """
        graphs = list(graphs)
        out: List = [None] * len(graphs)
        entries: List[Tuple[int, Prepared]] = []
        failures: Dict[int, Exception] = {}
        for i, g in enumerate(graphs):
            try:
                entries.append((i, self._prepared(g)))
            except Exception as e:  # noqa: BLE001 — isolated per request
                self.failed += 1
                failures[i] = e
        if failures and not return_exceptions:
            raise PlacementRequestError(
                failures, {i: getattr(graphs[i], "name", "?")
                           for i in failures})
        for i, e in failures.items():
            out[i] = e
        groups: Dict[Tuple[int, int], List[Tuple[int, Prepared]]] = {}
        for i, entry in entries:
            groups.setdefault(self._bucket_shape(entry.arrays), []).append(
                (i, entry))
        for bucket, members in groups.items():
            self.decode_bucket(bucket, members, out)
        return out

    # ------------------------------------------------------------ telemetry
    def stats(self) -> Dict[str, int]:
        stats = {"requests": self.requests,
                 "failed": self.failed,
                 "cache_hits": self.cache_hits,
                 "cache_misses": self.cache_misses,
                 "cached_graphs": len(self._prepared_lru),
                 "shape_keys_seen": len(self.shape_keys_seen),
                 "aot_decodes": self.aot_decodes}
        if self._aot is not None:
            stats.update(self._aot.stats())
        return stats
