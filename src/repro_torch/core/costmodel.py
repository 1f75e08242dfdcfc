"""Latency cost model, host half — the reward source for HSDAG's RL loop
(paper §2.5).

A calibrated DAG list-scheduler simulator:

  * per-op time on device d  =  max(flops / peak_d, bytes / bw_d) + dispatch_d
  * cross-device edge (u→v)  =  bytes_u / link_bw[d_u, d_v] + link_lat[d_u, d_v]
  * devices execute their ops on their queues in a fixed retire order; the
    makespan of the schedule is the placement's latency; reward = 1 / latency.

``simulate`` is the f64 reference scheduler.  ``sim_arrays`` precomputes the
placement-independent dense view (:class:`SimArrays`) that the level-parallel
makespan kernel (``kernels/levelsim.py``) scores batches of placements on.
``pad_sim_arrays`` / ``sim_arrays_batch`` / ``sim_arrays_bucketed`` pad such
views to a common node count for multi-graph batches (pad slots are inert
data ops), and ``critical_path`` is a lower bound on any placement's
makespan.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .graph import CompGraph, topological_order

__all__ = [
    "DeviceSpec", "Platform", "simulate", "SimResult", "paper_platform",
    "SimArrays", "sim_arrays", "BatchSimResult", "SimArraysBatch",
    "pad_sim_arrays", "sim_arrays_batch", "plan_buckets",
    "sim_arrays_bucketed", "critical_path", "tpu_stage_platform",
]


#: op-type → op-class used for per-class device efficiency.  "data" ops
#: (weights/inputs resident on the consumer device) cost nothing and their
#: out-edges pay no transfer.
_OP_CLASS = {
    "Const": "data", "Parameter": "data", "Convert": "data",
    "Convolution": "conv",
    "MatMul": "gemm", "Gemm": "gemm", "dot_general": "gemm",
    "conv_general_dilated": "conv",
}


def op_class(op_type: str) -> str:
    return _OP_CLASS.get(op_type, "eltwise")


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    kind: str                    # "cpu" | "gpu" | "tpu-stage"
    peak_flops: float            # FLOP/s (effective)
    mem_bw: float                # bytes/s
    dispatch_overhead: float     # s per op (driver/queue cost)
    mem_capacity: float = math.inf   # bytes
    # Fraction of peak achieved per op class (batch-1 inference realities:
    # convs/gemms at small batch run well below peak, differently per device).
    efficiency: Tuple[Tuple[str, float], ...] = (
        ("conv", 1.0), ("gemm", 1.0), ("eltwise", 1.0))
    # Occupancy ramp: ops with fewer output elements than this under-fill the
    # device (wide-SIMD/occupancy effect — the reason Table 2's GPU-only barely
    # helps Inception-V3 while halving BERT).  0 disables.
    util_ramp_elems: float = 0.0
    # Per-class dispatch override (e.g. OpenVINO's GPU conv path pays far more
    # per-op than its fused gemm path — visible in Table 2's per-op averages).
    dispatch_per_class: Tuple[Tuple[str, float], ...] = ()
    # Independent execution queues (multicore CPU runs parallel DAG branches
    # concurrently — the reason Inception-V3 stays competitive on CPU in
    # Table 2; accelerator streams mostly serialize).
    parallel_queues: int = 1

    def dispatch(self, cls: str) -> float:
        for k, v in self.dispatch_per_class:
            if k == cls:
                return v
        return self.dispatch_overhead

    def eff(self, cls: str, out_elems: float = 0.0) -> float:
        base = 1.0
        for k, v in self.efficiency:
            if k == cls:
                base = v
                break
        if self.util_ramp_elems > 0 and cls in ("conv", "gemm") and out_elems > 0:
            base *= min(1.0, out_elems / self.util_ramp_elems)
        return base


@dataclasses.dataclass(frozen=True)
class Platform:
    devices: Tuple[DeviceSpec, ...]
    link_bw: np.ndarray          # (D, D) bytes/s, inf on diagonal
    link_latency: np.ndarray     # (D, D) s, 0 on diagonal
    # Optional device coordinates (D, C) — topology builders set them (island
    # index, torus row/col, ...); consumed by the device feature table that
    # conditions the ``head="device"`` policy.  Purely descriptive: the cost
    # model reads only the link matrices.
    coords: Optional[np.ndarray] = None

    def __post_init__(self):
        d = len(self.devices)
        for attr, mat in (("link_bw", self.link_bw),
                          ("link_latency", self.link_latency)):
            mat = np.asarray(mat)
            if mat.shape != (d, d):
                raise ValueError(
                    f"Platform.{attr} must be ({d}, {d}) for {d} devices; "
                    f"got shape {mat.shape}")
            diag = np.diagonal(mat)
            if attr == "link_bw":
                bad = np.flatnonzero(~np.isinf(diag))
                if bad.size:
                    i = int(bad[0])
                    raise ValueError(
                        f"Platform.link_bw diagonal must be inf (a device "
                        f"never pays transfer to itself); link_bw[{i}, {i}] "
                        f"= {diag[i]!r}")
            else:
                bad = np.flatnonzero(diag != 0.0)
                if bad.size:
                    i = int(bad[0])
                    raise ValueError(
                        f"Platform.link_latency diagonal must be 0; "
                        f"link_latency[{i}, {i}] = {diag[i]!r}")
            off = ~np.eye(d, dtype=bool)
            invalid = off & (~np.isfinite(mat) | (mat < 0)
                             | ((mat == 0) if attr == "link_bw" else False))
            bad_ij = np.argwhere(invalid)
            if bad_ij.size:
                i, j = (int(x) for x in bad_ij[0])
                raise ValueError(
                    f"Platform.{attr}[{i}, {j}] = {mat[i, j]!r} — "
                    f"off-diagonal entries must be finite, "
                    f"{'positive' if attr == 'link_bw' else 'non-negative'}")
        if self.coords is not None:
            c = np.asarray(self.coords)
            if c.ndim != 2 or c.shape[0] != d:
                raise ValueError(
                    f"Platform.coords must be ({d}, C); got shape {c.shape}")

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def device_names(self) -> List[str]:
        return [d.name for d in self.devices]


def _uniform_links(n: int, bw: float, lat: float) -> Tuple[np.ndarray, np.ndarray]:
    link_bw = np.full((n, n), bw)
    np.fill_diagonal(link_bw, math.inf)
    link_lat = np.full((n, n), lat)
    np.fill_diagonal(link_lat, 0.0)
    return link_bw, link_lat


def paper_platform() -> Platform:
    """The paper's measurement host (§3.2), as cost-model constants.

    CPU: i9-12900K — ~0.8 TFLOP/s effective f32, ~76 GB/s DDR5, cheap dispatch.
    GPU: Data Center GPU Flex 170 — ~16 TFLOP/s f32, ~560 GB/s, costly per-op
    dispatch (driver + PCIe doorbell), PCIe4 x16 (~25 GB/s) to host.
    The iGPU is excluded, matching the paper's Limitations; num_devices = 2
    (Appendix H).
    """
    devices = (
        DeviceSpec("CPU", "cpu", peak_flops=1.1e12, mem_bw=76e9,
                   dispatch_overhead=1.5e-6, mem_capacity=64e9,
                   efficiency=(("conv", 0.55), ("gemm", 0.80),
                               ("eltwise", 1.0)),
                   parallel_queues=4),
        DeviceSpec("GPU", "gpu", peak_flops=16e12, mem_bw=560e9,
                   dispatch_overhead=4e-6, mem_capacity=16e9,
                   efficiency=(("conv", 0.30), ("gemm", 0.70),
                               ("eltwise", 1.0)),
                   dispatch_per_class=(("conv", 60e-6), ("eltwise", 6e-6))),
    )
    bw, lat = _uniform_links(2, bw=22e9, lat=8e-6)
    return Platform(devices, bw, lat)


def tpu_stage_platform(num_stages: int = 2, chips_per_stage: int = 256,
                       inter_stage_bw: float = 25e9) -> Platform:
    """TPU pods as placement targets for the production planner.

    Each "device" is one pod/pipeline stage (aggregate v5e chips); inter-stage
    links are the slower cross-pod DCI (vs ~50 GB/s/link intra-pod ICI).  A
    simulated platform, copied from the reference with its constants, so a
    plan scores the same in both packages.
    """
    devices = tuple(
        DeviceSpec(f"pod{i}", "tpu-stage",
                   peak_flops=197e12 * chips_per_stage,
                   mem_bw=819e9 * chips_per_stage,
                   dispatch_overhead=2e-6,
                   mem_capacity=16e9 * chips_per_stage)
        for i in range(num_stages))
    bw, lat = _uniform_links(num_stages, bw=inter_stage_bw, lat=4e-6)
    return Platform(devices, bw, lat)


@dataclasses.dataclass
class SimResult:
    latency: float                     # makespan, seconds
    per_device_busy: np.ndarray        # (D,) seconds of compute per device
    transfer_time: float               # total cross-device transfer seconds
    oom: bool

    @property
    def reward(self) -> float:
        """Paper §2.5: r = 1 / latency (0 when OOM, mirroring Table 2)."""
        return 0.0 if (self.oom or not math.isfinite(self.latency)) else 1.0 / self.latency


def _op_time(flops: float, byts: float, dev: DeviceSpec,
             cls: str = "eltwise", eff_hint: Optional[float] = None) -> float:
    """Time of one op on one device.

    ``eff_hint`` — per-node achieved-efficiency override (a measured-cost-model
    lookup, set by graph builders per kernel family), taking precedence over
    the per-class default.  Production placement systems use exactly such
    per-kernel tables; a closed-form efficiency model cannot reproduce the
    2× opposite-direction CPU/GPU efficiency swings visible in paper Table 2.
    """
    if cls == "data":
        return 0.0
    eff = eff_hint if eff_hint is not None else dev.eff(cls, out_elems=byts / 4.0)
    return (max(flops / (dev.peak_flops * eff), byts / dev.mem_bw)
            + dev.dispatch(cls))


def _eff_hint(node, dev: DeviceSpec) -> Optional[float]:
    if node.meta:
        v = node.meta.get(f"eff_{dev.kind}")
        if v is not None:
            return float(v)
    return None


def simulate(g: CompGraph, placement: Sequence[int], platform: Platform,
             order: Optional[np.ndarray] = None) -> SimResult:
    """List-schedule ``g`` under ``placement`` and return its makespan."""
    placement = np.asarray(placement, dtype=np.int64)
    n = g.num_nodes
    assert placement.shape == (n,), (placement.shape, n)
    if order is None:
        order = topological_order(g)
    preds: List[List[int]] = [[] for _ in range(n)]
    for s, d in g.edges:
        preds[int(d)].append(int(s))

    flops = g.flops()
    byts = g.bytes_out()
    classes = [op_class(node.op_type) for node in g.nodes]

    # OOM check: resident bytes (weights/activations proxy) per device.
    dev_bytes = np.zeros(platform.num_devices)
    np.add.at(dev_bytes, placement, byts)
    oom = any(dev_bytes[i] > platform.devices[i].mem_capacity
              for i in range(platform.num_devices))

    finish = np.zeros(n)
    # Each device owns `parallel_queues` independent queues; an op takes the
    # earliest-available one (list scheduling on identical machines).
    queues = [np.zeros(max(1, platform.devices[i].parallel_queues))
              for i in range(platform.num_devices)]
    busy = np.zeros(platform.num_devices)
    transfer_total = 0.0
    for v in order:
        v = int(v)
        d = int(placement[v])
        if classes[v] == "data":
            finish[v] = 0.0   # resident weights/inputs: free, no queue time
            continue
        ready = 0.0
        for u in preds[v]:
            t = finish[u]
            du = int(placement[u])
            if du != d and classes[u] != "data":
                tx = byts[u] / platform.link_bw[du, d] + platform.link_latency[du, d]
                t += tx
                transfer_total += tx
            ready = max(ready, t)
        dur = _op_time(flops[v], byts[v], platform.devices[d], classes[v],
                       _eff_hint(g.nodes[v], platform.devices[d]))
        q = int(np.argmin(queues[d]))
        start = max(ready, queues[d][q])
        finish[v] = start + dur
        queues[d][q] = finish[v]
        busy[d] += dur
    latency = float(finish.max()) if n else 0.0
    return SimResult(latency, busy, float(transfer_total), oom)


class SimArrays(NamedTuple):
    """Placement-independent dense view of one (graph, platform) pair.

    All fields are numpy arrays; static sizes are recovered from shapes.  Shapes:
    V nodes, P = max in-degree (≥1), D devices, Q = max parallel queues.

    ``order`` is the list-schedule retire order.  Device queues make the
    schedule order-sensitive, so the order is part of the cost model:
    ``schedule="topo"`` (default, heap-Kahn — the reference scheduler's
    default order, pinned by the golden latencies) or ``schedule="level"``
    (level-major stable re-sort — the order the level-parallel makespan
    kernel retires nodes in).
    """

    order: np.ndarray        # (V,) i32 — topological order
    preds: np.ndarray        # (V, P) i32 — row i: preds of node order[i], pad=V
    levels: np.ndarray       # (V,) i32 — topo level per node
    op_time: np.ndarray      # (D, V) f32 — per-op duration per device (0=data)
    bytes_out: np.ndarray    # (V+1,) f32 — bytes emitted; 0 at the pad slot
    is_data: np.ndarray      # (V+1,) bool — "data"-class ops; True at pad
    inv_bw: np.ndarray       # (D, D) f32 — 1/link_bw, 0 on the diagonal
    lat: np.ndarray          # (D, D) f32 — link latency, 0 on the diagonal
    mem_capacity: np.ndarray  # (D,) f32
    queue_init: np.ndarray   # (D, Q) f32 — 0 for real queues, +inf for masked
    # (V, D) bool — node v's resident bytes alone fit device d's capacity.
    # The per-node slice of the ``dev_bytes > mem_capacity`` OOM check: a
    # False entry means device d can *never* hold node v regardless of the
    # rest of the placement.  The ``head="device"`` policy masks such actions
    # at sample time; pad slots (zero bytes) are True everywhere, so padded
    # batches never constrain real clusters.  Unused by the level kernel.
    fit_ok: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.order.shape[0])

    @property
    def num_devices(self) -> int:
        return int(self.op_time.shape[0])


def _build_sim_arrays(g: CompGraph, platform: Platform,
                      schedule: str = "topo") -> SimArrays:
    n = g.num_nodes
    order = topological_order(g).astype(np.int32)
    preds: List[List[int]] = [[] for _ in range(n)]
    for s, d in g.edges:
        preds[int(d)].append(int(s))

    levels = np.zeros(n, dtype=np.int32)
    for v in order:
        v = int(v)
        if preds[v]:
            levels[v] = 1 + max(levels[u] for u in preds[v])

    if schedule == "level":
        # Level-major retire order: stable sort of the topo order by node
        # level (ties keep topo position).  Still a topological order, but a
        # different — equally valid — list schedule than heap-Kahn when
        # parallel branches contend for device queues.
        order = order[np.argsort(levels[order], kind="stable")]
    elif schedule != "topo":
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"expected 'topo' or 'level'")

    p_max = max([len(p) for p in preds], default=0) or 1
    pred_tab = np.full((n, p_max), n, dtype=np.int32)       # pad = sentinel n
    for i, v in enumerate(order):
        pv = preds[int(v)]
        pred_tab[i, :len(pv)] = pv

    flops = g.flops()
    byts = g.bytes_out()
    classes = [op_class(node.op_type) for node in g.nodes]
    ndev = platform.num_devices
    op_time = np.zeros((ndev, n), dtype=np.float64)
    for d, dev in enumerate(platform.devices):
        for v in range(n):
            op_time[d, v] = _op_time(flops[v], byts[v], dev, classes[v],
                                     _eff_hint(g.nodes[v], dev))

    q_max = max(max(1, dev.parallel_queues) for dev in platform.devices)
    queue_init = np.full((ndev, q_max), np.inf, dtype=np.float32)
    for d, dev in enumerate(platform.devices):
        queue_init[d, :max(1, dev.parallel_queues)] = 0.0

    inv_bw = np.where(np.isfinite(platform.link_bw),
                      1.0 / platform.link_bw, 0.0)
    np.fill_diagonal(inv_bw, 0.0)

    capacity = np.asarray([dev.mem_capacity for dev in platform.devices],
                          np.float32)
    fit_ok = byts.astype(np.float32)[:, None] <= capacity[None, :]

    return SimArrays(
        order=order,
        preds=pred_tab,
        levels=levels,
        op_time=op_time.astype(np.float32),
        bytes_out=np.concatenate([byts, [0.0]]).astype(np.float32),
        is_data=np.asarray([c == "data" for c in classes] + [True]),
        inv_bw=inv_bw.astype(np.float32),
        lat=platform.link_latency.astype(np.float32),
        mem_capacity=capacity,
        queue_init=queue_init,
        fit_ok=fit_ok,
    )


# graph → {(graph fingerprint, platform fingerprint): SimArrays}.  WeakKey so
# dropping a graph drops its cache; platforms are hashed by value (DeviceSpec
# is a frozen dataclass, link matrices by content).  The graph fingerprint
# covers everything ``_build_sim_arrays`` reads — topology, flops/bytes,
# op types (they pick the op class, hence durations and the "data" mask) and
# per-node ``eff_*`` meta hints — so *any* post-cache mutation (add_op /
# add_edge / op-type rewrites / in-place eff-hint edits) misses the stale
# entry and rebuilds instead of silently serving old durations.
_SIM_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _graph_fingerprint(g: CompGraph):
    """Content hash of every graph property the dense build consumes."""
    eff_hints = tuple(
        (i, tuple(sorted((k, float(v)) for k, v in node.meta.items()
                         if k.startswith("eff_"))))
        for i, node in enumerate(g.nodes)
        if node.meta and any(k.startswith("eff_") for k in node.meta))
    return (g.num_nodes, g.num_edges, g.edges.tobytes(),
            g.flops().tobytes(), g.bytes_out().tobytes(),
            tuple(g.op_types()), eff_hints)


def _cache_key(g: CompGraph, platform: Platform):
    return _graph_fingerprint(g) + (
        platform.devices, platform.link_bw.tobytes(),
        platform.link_latency.tobytes())


def sim_arrays(g: CompGraph, platform: Platform, *,
               schedule: str = "topo") -> SimArrays:
    """The precompiled (cached) dense view the level kernel scores on.

    ``schedule`` picks the retire order baked into ``order``/``preds`` (see
    :class:`SimArrays`); each (graph, platform, schedule) triple caches its
    own entry.
    """
    if schedule not in ("topo", "level"):
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"expected 'topo' or 'level'")
    per_graph = _SIM_CACHE.setdefault(g, {})
    key = _cache_key(g, platform) + (schedule,)
    sa = per_graph.get(key)
    if sa is None:
        sa = per_graph[key] = _build_sim_arrays(g, platform, schedule)
    return sa


@dataclasses.dataclass
class BatchSimResult:
    """Host-side view of a batched simulation over B placements."""

    latency: np.ndarray          # (B,) seconds
    reward: np.ndarray           # (B,) 1/latency, 0 on OOM
    oom: np.ndarray              # (B,) bool
    per_device_busy: np.ndarray  # (B, D) seconds
    transfer_time: np.ndarray    # (B,) seconds

    def __len__(self) -> int:
        return int(self.latency.shape[0])


# --------------------------------------------------------------------------
# Multi-graph batching: pad per-graph SimArrays to a common (G, V_max) shape.
#
# The padding contract: every pad slot is a zero-byte "data" op with zero
# duration and sentinel-only predecessors, appended *after* the real
# topological order.  Data ops are exact no-ops in the list schedule (finish
# pinned to 0, queues and the transfer sum untouched), so the padded
# makespan is bitwise the unpadded one.
# --------------------------------------------------------------------------


class SimArraysBatch(NamedTuple):
    """G padded :class:`SimArrays` stacked on a leading graph axis.

    ``arrays`` holds one SimArrays whose every field carries a leading G
    axis; ``node_mask`` marks real node slots (pad slots are inert data ops).
    """

    arrays: SimArrays        # each field: (G, ...) stacked padded view
    node_mask: np.ndarray    # (G, V_max) bool — True at real node slots
    num_nodes: np.ndarray    # (G,) int32 — real node count per graph

    @property
    def num_graphs(self) -> int:
        return int(self.node_mask.shape[0])

    @property
    def max_nodes(self) -> int:
        return int(self.node_mask.shape[1])

    @property
    def num_devices(self) -> int:
        return int(self.arrays.op_time.shape[1])


def pad_sim_arrays(sa: SimArrays, v_max: int,
                   p_max: Optional[int] = None) -> SimArrays:
    """Pad one graph's dense view to ``v_max`` node slots / ``p_max`` preds.

    Pad slots are data ops (no duration, no bytes, sentinel preds), so the
    padded view's makespan matches the unpadded one exactly for any
    ``v_max >= V`` — including V_max ≫ V.
    """
    n = sa.num_nodes
    p = sa.preds.shape[1]
    p_max = p if p_max is None else p_max
    if v_max < n or p_max < p:
        raise ValueError(f"cannot pad {n} nodes/{p} preds down to "
                         f"({v_max}, {p_max})")
    if v_max == n and p_max == p:
        return sa
    order = np.concatenate([sa.order,
                            np.arange(n, v_max, dtype=np.int32)])
    # Real rows keep their original sentinel n; pad rows use v_max.  Both
    # slots are data ops in the padded view, so both sentinels are inert.
    preds = np.full((v_max, p_max), v_max, dtype=np.int32)
    preds[:n, :p] = sa.preds
    levels = np.concatenate([sa.levels, np.zeros(v_max - n, np.int32)])
    ndev = sa.op_time.shape[0]
    op_time = np.zeros((ndev, v_max), np.float32)
    op_time[:, :n] = sa.op_time
    bytes_out = np.zeros(v_max + 1, np.float32)
    bytes_out[:n] = sa.bytes_out[:n]
    is_data = np.ones(v_max + 1, bool)
    is_data[:n] = sa.is_data[:n]
    fit_ok = np.ones((v_max, sa.fit_ok.shape[1]), bool)  # pads fit anywhere
    fit_ok[:n] = sa.fit_ok
    return SimArrays(order=order, preds=preds, levels=levels,
                     op_time=op_time, bytes_out=bytes_out, is_data=is_data,
                     inv_bw=sa.inv_bw, lat=sa.lat,
                     mem_capacity=sa.mem_capacity, queue_init=sa.queue_init,
                     fit_ok=fit_ok)


def sim_arrays_batch(graphs: Sequence[CompGraph], platform: Platform, *,
                     v_max: Optional[int] = None,
                     p_max: Optional[int] = None,
                     schedule: str = "topo") -> SimArraysBatch:
    """Stack ``graphs`` into one padded (G, V_max) batch for ``platform``.

    ``v_max``/``p_max`` pin the node/predecessor axes beyond the batch
    maximum (a bucketed trainer fixes them per size bucket).
    """
    if not graphs:
        raise ValueError("sim_arrays_batch needs at least one graph")
    if any(g.num_nodes == 0 for g in graphs):
        raise ValueError("cannot batch an empty graph")
    sas = [sim_arrays(g, platform, schedule=schedule) for g in graphs]
    vm = max(sa.num_nodes for sa in sas)
    if v_max is not None:
        if v_max < vm:
            raise ValueError(f"v_max={v_max} < largest graph ({vm} nodes)")
        vm = v_max
    pm = max(sa.preds.shape[1] for sa in sas)
    if p_max is not None:
        if p_max < pm:
            raise ValueError(f"p_max={p_max} < largest in-degree ({pm})")
        pm = p_max
    padded = [pad_sim_arrays(sa, vm, pm) for sa in sas]
    stacked = SimArrays(*[np.stack([getattr(sa, f) for sa in padded])
                          for f in SimArrays._fields])
    node_mask = np.zeros((len(sas), vm), dtype=bool)
    for i, sa in enumerate(sas):
        node_mask[i, :sa.num_nodes] = True
    return SimArraysBatch(stacked, node_mask,
                          np.asarray([sa.num_nodes for sa in sas], np.int32))


# --------------------------------------------------------------------------
# Size-bucketed batching: bound pad waste for corpora whose sizes span a
# wide range — each bucket is padded only to its own maximum, and the
# padding contract keeps every bucket's makespans bitwise the unpadded ones.
# --------------------------------------------------------------------------


def plan_buckets(sizes: Sequence[int], max_buckets: int) -> List[List[int]]:
    """Partition graph indices into ≤ ``max_buckets`` size-contiguous buckets
    minimizing total pad waste (Σ bucket_max − size; exact DP over the sorted
    sizes).  Deterministic: ties keep input order; buckets are returned
    smallest-sizes first.
    """
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    n = len(sizes)
    if n == 0:
        return []
    order = sorted(range(n), key=lambda i: (sizes[i], i))
    s = [int(sizes[i]) for i in order]
    k = min(max_buckets, n)
    # cost(i, j): waste of one bucket spanning sorted slots i..j (pad to s[j])
    prefix = np.concatenate([[0], np.cumsum(s)])

    def cost(i, j):
        return s[j] * (j - i + 1) - (prefix[j + 1] - prefix[i])
    INF = float("inf")
    dp = [[INF] * (k + 1) for _ in range(n + 1)]   # dp[j][b]: first j slots
    cut = [[0] * (k + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    for j in range(1, n + 1):
        for b in range(1, k + 1):
            for i in range(b - 1, j):
                c = dp[i][b - 1] + cost(i, j - 1)
                if c < dp[j][b]:
                    dp[j][b] = c
                    cut[j][b] = i
    best_b = min(range(1, k + 1), key=lambda b: (dp[n][b], b))
    bounds = []
    j, b = n, best_b
    while b > 0:
        i = cut[j][b]
        bounds.append((i, j))
        j, b = i, b - 1
    return [[order[t] for t in range(i, j)] for i, j in reversed(bounds)]


def sim_arrays_bucketed(graphs: Sequence[CompGraph], platform: Platform, *,
                        max_buckets: int, schedule: str = "topo",
                        buckets: Optional[List[List[int]]] = None
                        ) -> Tuple[List[List[int]], List[SimArraysBatch]]:
    """→ (buckets, batches): the graphs split into ≤ ``max_buckets`` padded
    batches, each padded to its *bucket's* maximum.  ``buckets`` overrides
    the :func:`plan_buckets` partition (any index partition is valid).
    """
    if buckets is None:
        buckets = plan_buckets([g.num_nodes for g in graphs], max_buckets)
    batches = [sim_arrays_batch([graphs[i] for i in idx], platform,
                                schedule=schedule)
               for idx in buckets]
    return buckets, batches


def critical_path(g: CompGraph, platform: Platform) -> float:
    """Lower bound: longest path assuming every op runs on its best device
    and transfers are free."""
    n = g.num_nodes
    best = np.array([min(_op_time(node.flops, node.bytes_out, d,
                                  op_class(node.op_type), _eff_hint(node, d))
                         for d in platform.devices) for node in g.nodes])
    order = topological_order(g)
    dist = np.zeros(n)
    preds: List[List[int]] = [[] for _ in range(n)]
    for s, d in g.edges:
        preds[int(d)].append(int(s))
    for v in order:
        v = int(v)
        p = max((dist[u] for u in preds[v]), default=0.0)
        dist[v] = p + best[v]
    return float(dist.max()) if n else 0.0
