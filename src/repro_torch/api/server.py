"""AsyncPlacementServer — continuous bucket-batching over per-request
futures, PyTorch port.

Port of ``repro/api/server.py``, with its admission, batching, tenancy,
lifecycle and ``stats()``.  :class:`~repro_torch.api.PlacementService`
batches bursts handed to it synchronously; this server forms the batches
itself from requests that arrive one at a time:

* **Per-request futures.**  :meth:`AsyncPlacementServer.submit` validates
  and featurises the request on the caller's thread (an out-of-vocabulary
  graph fails *its own* future immediately and never reaches a batch) and
  returns a :class:`concurrent.futures.Future` that resolves to the
  placement.
* **Continuous bucket-batching.**  Admitted requests queue per
  ``(tenant, bucket shape)``.  A background flusher drains a queue the
  moment it holds ``batch_slots`` requests (a full batch) or its oldest
  request has waited ``max_delay_ms`` (the deadline).  Each flush is one
  chunk decode through the owning tenant's warm service.
* **Multi-policy tenancy.**  A spec-hash-keyed registry of
  :class:`PlacementService` instances: :meth:`register` admits a fitted
  session (or checkpoint path) and returns its tenant id (``spec_hash`` by
  default).  Tenants share the queues and the flusher but nothing else.

The flusher decodes on its own thread.  Grad mode is per thread in
PyTorch, so the caller's setting does not carry over: the flusher enters
``torch.no_grad()`` itself, and decodes on each service's device.  A decode
error settles exactly that batch's futures with the error, as in the
reference; it is the error reaching the caller, not a fallback.

Lifecycle: the flusher starts on construction and drains outstanding
queues on :meth:`close` (``with AsyncPlacementServer(...) as srv`` closes
deterministically).  After close, ``submit`` raises and pending futures
are still served.  ``device=`` applies to sessions registered by checkpoint
path: the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.graph import CompGraph
from .aot import AotExecutableCache
from .service import PlacementService, Prepared
from .session import PlacementSession

__all__ = ["AsyncPlacementServer"]


class _Pending:
    """One admitted request waiting in a bucket queue."""

    __slots__ = ("prepared", "future", "t_submit")

    def __init__(self, prepared: Prepared, future: Future,
                 t_submit: float):
        self.prepared = prepared
        self.future = future
        self.t_submit = t_submit


class AsyncPlacementServer:
    """See module docstring.  Example::

        server = AsyncPlacementServer(batch_slots=4, max_delay_ms=5.0,
                                      aot_cache="ckpt/aot")
        tenant_a = server.register(session_a)         # spec-hash tenant ids
        tenant_b = server.register("ckpt/policy_b")
        fut = server.submit(graph, tenant=tenant_a)   # per-request future
        placement = fut.result()
        server.close()                                # drains, then stops
    """

    def __init__(self, *, batch_slots: int = 4, max_delay_ms: float = 5.0,
                 cache_size: int = 64, size_granularity: int = 16,
                 aot_cache: Union[AotExecutableCache, str, None] = None,
                 device="cuda"):
        if max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        self.batch_slots = int(batch_slots)
        self.max_delay = float(max_delay_ms) / 1e3
        self._svc_kwargs = dict(cache_size=cache_size,
                                batch_slots=batch_slots,
                                size_granularity=size_granularity,
                                device=device)
        if isinstance(aot_cache, str):
            aot_cache = AotExecutableCache(aot_cache)
        self._aot = aot_cache
        self._tenants: "OrderedDict[str, PlacementService]" = OrderedDict()
        self._prep_locks: Dict[str, threading.Lock] = {}
        self._queues: Dict[Tuple[str, Tuple[int, int]],
                           Deque[_Pending]] = {}
        self._cv = threading.Condition()
        self._closed = False
        self.batches_full = 0
        self.batches_deadline = 0
        self._flusher = threading.Thread(target=self._run,
                                         name="placement-flusher",
                                         daemon=True)
        self._flusher.start()

    # ------------------------------------------------------------- tenancy
    def register(self,
                 session: Union[PlacementSession, PlacementService, str],
                 *, tenant: Optional[str] = None) -> str:
        """Admit a fitted session/checkpoint/service; → its tenant id.

        The id defaults to the session spec's ``spec_hash()`` — the same
        key the AOT cache partitions by — so re-registering the same policy
        is idempotent and two different policies can never collide.  Pass
        ``tenant=`` to alias it.
        """
        if isinstance(session, PlacementService):
            service = session
        else:
            service = PlacementService(session, aot_cache=self._aot,
                                       **self._svc_kwargs)
        if tenant is None:
            if service.session.spec is None:
                raise ValueError("session carries no spec — pass tenant= "
                                 "explicitly")
            tenant = service.session.spec.spec_hash()
        with self._cv:
            if self._closed:
                raise RuntimeError("server is closed")
            self._tenants[str(tenant)] = service
            self._prep_locks.setdefault(str(tenant), threading.Lock())
        return str(tenant)

    def tenants(self) -> List[str]:
        with self._cv:
            return list(self._tenants)

    def _resolve(self, tenant: Optional[str]) -> Tuple[str,
                                                       PlacementService]:
        with self._cv:
            if tenant is None:
                if len(self._tenants) != 1:
                    raise ValueError(
                        f"tenant= is required when {len(self._tenants)} "
                        f"policies are registered (tenants: "
                        f"{list(self._tenants)})")
                tenant = next(iter(self._tenants))
            svc = self._tenants.get(str(tenant))
            if svc is None:
                raise KeyError(
                    f"unknown tenant {tenant!r}; registered: "
                    f"{list(self._tenants)}")
            return str(tenant), svc

    # ------------------------------------------------------------ admission
    def submit(self, graph: CompGraph, *,
               tenant: Optional[str] = None) -> Future:
        """Admit one request; → a Future resolving to the placement.

        Validation (vocab check + featurisation) runs here, on the caller's
        thread: an invalid graph fails its own future immediately and is
        never enqueued.  Valid requests enter their ``(tenant, bucket)``
        queue and resolve when the flusher decodes the batch.
        """
        with self._cv:
            if self._closed:
                raise RuntimeError("server is closed to new requests")
        tenant_id, svc = self._resolve(tenant)
        future: Future = Future()
        future.set_running_or_notify_cancel()   # not cancellable: admitted
        with self._prep_locks[tenant_id]:       # guards the LRU and counters
            try:
                prepared = svc._prepared(graph)
            except Exception as e:              # noqa: BLE001 — per-request
                svc.failed += 1
                future.set_exception(e)
                return future
        bucket = svc._bucket_shape(prepared.arrays)
        pending = _Pending(prepared, future, time.monotonic())
        with self._cv:
            if self._closed:
                raise RuntimeError("server is closed to new requests")
            self._queues.setdefault((tenant_id, bucket),
                                    deque()).append(pending)
            self._cv.notify()
        return future

    def place(self, graph: CompGraph, *,
              tenant: Optional[str] = None,
              timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(graph, tenant=tenant).result(timeout)

    def place_many(self, graphs: Sequence[CompGraph], *,
                   tenant: Optional[str] = None,
                   return_exceptions: bool = False,
                   timeout: Optional[float] = None) -> List:
        """Submit a burst; gather results in request order.

        With ``return_exceptions=True`` failed requests yield their
        exception in-slot; otherwise the first failure raises (after all
        futures settle, so valid requests are still decoded and cached).
        """
        futures = [self.submit(g, tenant=tenant) for g in graphs]
        out: List = []
        first_error: Optional[Exception] = None
        for f in futures:
            try:
                out.append(f.result(timeout))
            except Exception as e:              # noqa: BLE001
                if not return_exceptions and first_error is None:
                    first_error = e
                out.append(e)
        if first_error is not None:
            raise first_error
        return out

    # ------------------------------------------------------------- flusher
    def _ready_key(self, now: float):
        """→ (key, deadline-expired) of the ripest queue, or (None, ...)."""
        best_key, best_age = None, -1.0
        for key, q in self._queues.items():
            if not q:
                continue
            if len(q) >= self.batch_slots:
                return key, True
            age = now - q[0].t_submit
            if age >= self.max_delay:
                return key, True
            if age > best_age:
                best_key, best_age = key, age
        return (best_key, False)

    def _run(self) -> None:
        with torch.no_grad():
            while True:
                with self._cv:
                    while True:
                        now = time.monotonic()
                        key, ripe = self._ready_key(now)
                        if key is not None and (ripe or self._closed):
                            break
                        if self._closed and key is None:
                            return
                        if key is None:
                            self._cv.wait()
                        else:
                            # sleep until the oldest request's deadline
                            expiry = (self._queues[key][0].t_submit
                                      + self.max_delay)
                            self._cv.wait(timeout=max(expiry - now, 1e-4))
                    q = self._queues[key]
                    batch = [q.popleft()
                             for _ in range(min(len(q), self.batch_slots))]
                    if len(batch) == self.batch_slots:
                        self.batches_full += 1
                    else:
                        self.batches_deadline += 1
                    tenant_id, bucket = key
                    svc = self._tenants[tenant_id]
                self._flush(svc, bucket, batch)

    def _flush(self, svc: PlacementService, bucket: Tuple[int, int],
               batch: List[_Pending]) -> None:
        """One chunk decode for one batch; settle its futures."""
        out: List = [None] * len(batch)
        members = [(i, p.prepared) for i, p in enumerate(batch)]
        try:
            svc.decode_bucket(bucket, members, out)
        except Exception as e:                  # noqa: BLE001
            # a decode failure is batch-scoped: settle exactly these
            # futures with it, leave every other queue untouched
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(e)
            return
        for p, placement in zip(batch, out):
            p.future.set_result(placement)

    # ------------------------------------------------------------ lifecycle
    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Stop admitting, drain every queue, stop the flusher."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._flusher.join(timeout)

    def __enter__(self) -> "AsyncPlacementServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ telemetry
    def stats(self) -> Dict:
        """Aggregate + per-tenant counters.

        ``recompiles`` sums the tenants' cold buckets (the reference's
        traced shapes) — bounded by the distinct (tenant, bucket) pairs in
        the stream; ``aot_decodes`` counts decodes of preloaded buckets.
        """
        with self._cv:
            tenants = dict(self._tenants)
            queued = sum(len(q) for q in self._queues.values())
        per_tenant = {t: s.stats() for t, s in tenants.items()}
        agg = {
            "tenants": len(per_tenant),
            "queued": queued,
            "batches_full": self.batches_full,
            "batches_deadline": self.batches_deadline,
            "requests": sum(s["requests"] for s in per_tenant.values()),
            "failed": sum(s["failed"] for s in per_tenant.values()),
            "recompiles": sum(s["shape_keys_seen"]
                              for s in per_tenant.values()),
            "aot_decodes": sum(s["aot_decodes"]
                               for s in per_tenant.values()),
        }
        return {**agg, "per_tenant": per_tenant}
