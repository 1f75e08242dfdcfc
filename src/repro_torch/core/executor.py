"""Measured-latency backend (paper-faithful reward path), PyTorch.

Port of ``repro/core/executor.py``.  The paper deploys each placement with
OpenVINO and measures wall-clock inference latency.  Here the graph is
*actually executed* on torch devices (the CUDA devices unless the caller
names others, e.g. ``["cpu", "cuda"]`` for the paper's CPU + GPU host):

  * every node becomes a proxy workload whose FLOPs and output bytes match
    the graph annotations (a matrix-vector product sized to the node's
    cost, ``tanh(w @ acc)``), with the reference's proxy sizes and weights
    (``default_rng(0)``), bit for bit;
  * each node runs on the device its placement assigns;
  * cross-device edges move real buffers with ``.to(device)``;
  * latency = wall-clock of the whole DAG execution, the card synchronised
    before the clock is read, measured the paper's way: ``warmup + timed``
    runs, the average of the last ``timed`` (§3, Table 2 caption).

Each distinct proxy weight is uploaded to a device once and cached, as the
reference caches it: BERT-base's proxies are 439 MB of distinct weights, and
a run streams ~2 bytes a FLOP.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .graph import CompGraph, topological_order

__all__ = ["MeasuredExecutor"]

_MAX_SIDE = 2048          # cap proxy matmul dims
_MAX_ELEMS = 1 << 20      # cap materialized buffer elements


def _proxy_dims(flops: float, out_elems: int) -> Tuple[int, int]:
    """(m, k) such that a (m,k)@(k,) matvec ≈ flops and m ≈ out elems."""
    m = int(min(max(out_elems, 8), _MAX_SIDE))
    k = int(min(max(flops / (2.0 * m), 8), _MAX_SIDE * 32))
    return m, k


class MeasuredExecutor:
    """Execute a CompGraph under a placement and time it."""

    def __init__(self, graph: CompGraph, devices: Optional[Sequence] = None,
                 warmup: int = 5, timed: int = 5):
        self.graph = graph
        if devices is None:
            resolve_device("cuda")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.devices = [resolve_device(d) for d in devices]
        self.warmup = warmup
        self.timed = timed
        self.order = topological_order(graph)
        n = graph.num_nodes
        self.preds: List[List[int]] = [[] for _ in range(n)]
        for s, d in graph.edges:
            self.preds[int(d)].append(int(s))

        # Static per-node proxy workloads: the weights drawn once on the
        # host, uploaded to a device on first use.
        self._dims: List[Tuple[int, int]] = []
        self._weights: Dict[Tuple[int, int], np.ndarray] = {}
        rng = np.random.default_rng(0)
        for node in graph.nodes:
            out_elems = int(min(max(node.bytes_out / 4.0, 8), _MAX_ELEMS))
            m, k = _proxy_dims(node.flops, out_elems)
            self._dims.append((m, k))
            if (m, k) not in self._weights:
                self._weights[(m, k)] = rng.standard_normal(
                    (m, k), dtype=np.float32) / np.sqrt(k)
        self._dev_weights: Dict[Tuple[int, int, int], torch.Tensor] = {}
        #: bytes of proxy weights uploaded to the devices so far
        self.bytes_uploaded = 0

    def _weight_on(self, m: int, k: int, dev_idx: int) -> torch.Tensor:
        key = (m, k, dev_idx)
        if key not in self._dev_weights:
            # The host weights are float64 (a float32 draw over a float64
            # square root); the device holds them in float32, as JAX's
            # device_put rounds them.
            w = self._weights[(m, k)].astype(np.float32)
            self._dev_weights[key] = torch.as_tensor(
                w, device=self.devices[dev_idx])
            self.bytes_uploaded += w.nbytes
        return self._dev_weights[key]

    def _sync(self) -> None:
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def outputs(self, placement: np.ndarray,
                fill: float = 0.0) -> List[torch.Tensor]:
        """Run the DAG once under ``placement`` → every node's output, on
        its device (the devices synchronised).

        Each node's input accumulator starts from ``fill``.  The reference
        starts it from 0, so the sources output tanh(W·0) = 0 and so does
        every node; a check of the outputs passes a nonzero ``fill``."""
        outs: List[Optional[torch.Tensor]] = [None] * self.graph.num_nodes
        for v in self.order:
            v = int(v)
            dev_idx = int(placement[v]) % len(self.devices)
            dev = self.devices[dev_idx]
            m, k = self._dims[v]
            w = self._weight_on(m, k, dev_idx)
            acc = torch.full((k,), fill, dtype=torch.float32, device=dev)
            for u in self.preds[v]:
                x = outs[u]
                if x.device != w.device:
                    x = x.to(dev)                     # real transfer
                n = min(x.shape[0], k)
                acc[:n] += x[:n]
            # xs_sum: (k,) reduced inputs; one matvec ≈ the node's FLOPs.
            outs[v] = torch.tanh(torch.matmul(w, acc))
        self._sync()
        return outs

    def _run_once(self, placement: np.ndarray) -> float:
        t0 = time.perf_counter()
        self.outputs(placement)
        return time.perf_counter() - t0

    def __call__(self, placement: np.ndarray) -> Tuple[float, float]:
        """reward, latency — measured as in the paper (the average of the
        last ``timed`` of ``warmup + timed`` runs)."""
        placement = np.asarray(placement)
        times = [self._run_once(placement)
                 for _ in range(self.warmup + self.timed)]
        latency = float(np.mean(times[self.warmup:]))
        return (1.0 / latency if latency > 0 else 0.0), latency
