"""Level-parallel makespan kernel — the ``level`` and ``scan`` simulator
backends' scorer.

Port of ``repro/kernels/levelsim.py``.  One call scores B placements of one
graph under the **level-major** list schedule: nodes retire level by level
(ties in the base topological order), each node waits for its predecessors'
finish times plus the cross-device transfer cost, then takes the
earliest-free queue of its device (first minimum).  Build the tables from
``sim_arrays(g, platform, schedule="level")`` and compare against
``simulate(g, p, platform, order=sa.order)``.

The same kernel on ``build_chain_arrays``' tables (one node a row) walks the
node-scan schedule of the reference's ``costmodel.simulate_jax`` instead:
the ``scan`` backend's reward.

"data"-class ops (weights/inputs resident on the consumer device) never
enter the tables: they cost nothing, their finish time stays 0, and their
out-edges pay no transfer.

``level_makespan`` launches the CUDA kernel ``csrc/levelsim.cu`` on CUDA
tensors and runs the plain PyTorch version ``level_makespan_ref`` on CPU
tensors.  The kernel has two routes; ``level_launch_plan`` picks one per
call from the shapes and is the mirror of the launch (lanes a placement,
warps a block, shared memory a block).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["LevelArrays", "build_level_arrays", "build_chain_arrays",
           "LevelTensors", "level_tensors", "level_makespan_ref",
           "level_makespan",
           "LevelPlan", "level_launch_plan", "level_record_offsets",
           "level_smem", "ROUTES", "PRE", "STATIC_WORDS", "PARAMS"]


class LevelArrays(NamedTuple):
    """Level-major tables over the *schedulable* (non-data) nodes.

    Shapes: L levels, W = max nodes per level, P = max in-degree, D devices.
    The node-id sentinel is V (one past the last real slot) — guaranteed to
    index an inert pad entry of the (V+1,)-shaped per-node vectors.
    """

    nodes: np.ndarray       # (L, W) i32 — node ids per level, pad = V
    preds: np.ndarray       # (L, W, P) i32 — predecessor ids, pad/data → V ok
    dur: np.ndarray         # (L, W, D) f32 — per-device duration of each slot
    pred_bytes: np.ndarray  # (L, W, P) f32 — bytes emitted by each pred
    pred_data: np.ndarray   # (L, W, P) f32 — 1.0 where pred is data/pad
    order: np.ndarray       # (V,) i32 — full level-major retire order

    @property
    def num_levels(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def max_width(self) -> int:
        return int(self.nodes.shape[1])


def build_level_arrays(sa) -> LevelArrays:
    """Regroup a ``SimArrays`` into per-level tables.

    ``sa`` is any ``core.costmodel.SimArrays`` (padded ones included — pad
    slots are data ops and drop out of the tables).  The kernel retires nodes
    in level-major order regardless of ``sa.order``'s schedule; pass arrays
    built with ``schedule="level"`` so ``sa.order`` matches what the kernel
    simulates (the returned ``order`` is always the level-major one).
    """
    order = np.asarray(sa.order, np.int64)
    levels = np.asarray(sa.levels, np.int64)
    is_data = np.asarray(sa.is_data)
    lvl_order = order[np.argsort(levels[order], kind="stable")]
    by_level: dict = {}
    for v in lvl_order:
        if not is_data[v]:
            by_level.setdefault(int(levels[v]), []).append(int(v))
    return _tables(sa, [by_level[k] for k in sorted(by_level)], lvl_order)


def build_chain_arrays(sa) -> LevelArrays:
    """One row per non-data node, in ``sa.order``'s order, each of width 1.

    With one slot a row, every predecessor of a row has retired before the
    row's readiness is taken, so ``level_makespan`` on these tables walks
    the node-scan list schedule of ``sa.order`` (the reference's
    ``simulate_jax``): pass ``sim_arrays(g, platform, schedule="topo")``
    for the heap-Kahn order.  The returned ``order`` is ``sa.order``.
    """
    order = np.asarray(sa.order, np.int64)
    is_data = np.asarray(sa.is_data)
    return _tables(sa, [[int(v)] for v in order if not is_data[v]], order)


def _tables(sa, rows, order) -> LevelArrays:
    """Tables of ``rows`` (lists of non-data node ids, retired row by row and
    in list order within a row), gathered per node from ``sa``; no row gives
    one row of sentinels."""
    n = order.shape[0]
    p_max = sa.preds.shape[1]
    ndev = sa.op_time.shape[0]

    # preds are stored per order-position; re-index them per node id.  Rows
    # of padded arrays may carry the *unpadded* sentinel — every sentinel
    # points at some data slot, so they are interchangeable here.
    pred_by_node = np.full((n + 1, p_max), n, dtype=np.int64)
    pred_by_node[np.asarray(sa.order, np.int64)] = np.asarray(sa.preds,
                                                              np.int64)

    L = max(len(rows), 1)
    W = max((len(r) for r in rows), default=1) or 1
    nodes = np.full((L, W), n, dtype=np.int32)
    preds = np.full((L, W, p_max), n, dtype=np.int32)
    dur = np.zeros((L, W, ndev), dtype=np.float32)
    pbytes = np.zeros((L, W, p_max), dtype=np.float32)
    pdata = np.ones((L, W, p_max), dtype=np.float32)
    bytes_out = np.asarray(sa.bytes_out, np.float32)
    data_vec = np.asarray(sa.is_data, np.float32)
    op_time = np.asarray(sa.op_time, np.float32)
    for l, row in enumerate(rows):
        w = len(row)
        nodes[l, :w] = row
        pv = pred_by_node[row]                          # (w, P)
        preds[l, :w] = pv
        dur[l, :w] = op_time[:, row].T
        pbytes[l, :w] = bytes_out[pv]
        pdata[l, :w] = data_vec[pv]
    return LevelArrays(nodes=nodes, preds=preds, dur=dur,
                       pred_bytes=pbytes, pred_data=pdata,
                       order=order.astype(np.int32))


#: routes of ``csrc/levelsim.cu``, in the order of its ``Route`` enum
ROUTES = ("staged", "general")
#: warps a block at most (the kernel's ``kMaxWarpsPerBlock``)
MAX_WARPS = 4
#: a placement's D·Q queue state is held in registers up to this many
#: queues (the kernel's ``kRegQueueMax``), in shared memory above it
REG_QUEUES = 8
#: dynamic shared memory a block may take on the H100 (227 KB)
SMEM_LIMIT = 232448
#: the H100's SMs: a launch spreads its placements over them before it puts
#: more in a block
SMS = 132
#: predecessors of a slot whose transfer terms the kernel precomputes (its
#: ``kPre``): the records' ``upre`` section holds their ids
PRE = 4
#: 4-byte words of a slot's precomputed half in shared memory (``kStatic``)
STATIC_WORDS = 4 + PRE
#: the launch's integer parameters, in the order of the kernel's ``Param``
#: enum (the ``params`` array it reads)
PARAMS = ("table_words", "off_nodes", "off_upre", "off_preds", "off_dur", "L",
          "W", "P", "V", "D", "Q", "S", "route", "group", "per_block",
          "warps")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _words16(n: int) -> int:
    """``n`` 4-byte words rounded up to whole 16-byte vectors."""
    return _cdiv(n, 4) * 4


@functools.lru_cache(maxsize=64)
def level_record_offsets(L: int, S: int, P: int, D: int) -> Tuple[int, ...]:
    """Word offsets of the sections of ``LevelTensors.records`` → (nodes,
    upre, preds, dur, total words).

    The records are one int32 array over the S real slots of the tables (pad
    slots dropped), in table order, each section starting on a 16-byte
    boundary: the (L+1,) offset of each level's first real slot, the (S,)
    node ids, the (S, PRE) ids of each slot's first PRE predecessors, the
    (S, P) predecessor records {pred id, its bytes as f32 bits} (8 bytes
    each), then the (S, D) durations as f32 bits.  The kernel copies the
    whole array into shared memory in 16-byte pieces and reads the sections
    at these offsets.
    """
    off_nodes = _words16(L + 1)
    off_upre = off_nodes + _words16(S)
    off_preds = off_upre + S * PRE
    off_dur = off_preds + _words16(2 * S * P)
    return off_nodes, off_upre, off_preds, off_dur, off_dur + _words16(S * D)


@dataclass(frozen=True, eq=False)
class LevelTensors:
    """:class:`LevelArrays` tables on one device, ready for a launch.

    Built by :func:`level_tensors`, which repacks the predecessor table once:
    a data or pad predecessor contributes finish 0 and transfer +0.0, so
    each slot lists only its real predecessors, in table order, and the rest
    of its row is the sentinel V (with ``pred_data`` 1 and ``pred_bytes``
    0).  P is the most real predecessors of any slot.  The plain version
    reads these tensors; the kernel reads ``records``, the same tables packed
    into one int32 array over the ``slots`` real slots
    (:func:`level_record_offsets`).  ``nodes_host`` keeps the (L, W) node
    table on the host, where the plain version reads its pad slots without a
    device round trip.

    The tensors are checked once, here: one device, the dtypes and shapes
    below, contiguous, ``records`` on a 16-byte boundary, and counts that
    fit the kernel's int32 indices.  So a launch checks only the placements
    and the platform's tensors.
    """

    nodes: torch.Tensor       # (L, W) i32, pad = V
    preds: torch.Tensor       # (L, W, P) i32, real preds first, then V
    dur: torch.Tensor         # (L, W, D) f32
    pred_bytes: torch.Tensor  # (L, W, P) f32
    pred_data: torch.Tensor   # (L, W, P) f32, 1 where preds == V
    records: torch.Tensor     # (words,) i32, the kernel's packed tables
    nodes_host: np.ndarray    # (L, W) i32
    num_nodes: int            # V, the sentinel
    slots: int                # S, the real (non-pad) slots
    #: (B, Q) → (plan, its ``params`` array) of the launches made so far
    launches: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        L, W, P, D = self.shape
        words = self.offsets[-1]
        if not 0 <= self.num_nodes < 2 ** 31 - 1 or 2 * words >= 2 ** 31:
            raise ValueError(f"LevelTensors: {self.num_nodes} nodes and "
                             f"{words} record words exceed the kernel's "
                             f"int32 indices")
        for name, dtype, shape in (("nodes", torch.int32, (L, W)),
                                   ("preds", torch.int32, (L, W, P)),
                                   ("dur", torch.float32, (L, W, D)),
                                   ("pred_bytes", torch.float32, (L, W, P)),
                                   ("pred_data", torch.float32, (L, W, P)),
                                   ("records", torch.int32, (words,))):
            t = getattr(self, name)
            if t.device != self.device or t.dtype != dtype \
                    or tuple(t.shape) != shape or not t.is_contiguous() \
                    or (name == "records" and t.data_ptr() % 16):
                raise ValueError(
                    f"LevelTensors: {name} must be a contiguous {dtype} "
                    f"tensor of shape {shape} on {self.device} (records on "
                    f"a 16-byte boundary); got {t.dtype} {tuple(t.shape)} "
                    f"on {t.device}")
        if self.nodes_host.shape != (L, W):
            raise ValueError(f"LevelTensors: nodes_host must have shape "
                             f"{(L, W)}; got {self.nodes_host.shape}")

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    @functools.cached_property
    def shape(self) -> Tuple[int, int, int, int]:
        """(L levels, W slots a level, P preds a slot, D devices)."""
        L, W, D = self.dur.shape
        return L, W, int(self.preds.shape[2]), D

    @functools.cached_property
    def offsets(self) -> Tuple[int, ...]:
        """:func:`level_record_offsets` of these tables."""
        L, _, P, D = self.shape
        return level_record_offsets(L, self.slots, P, D)


def _real_preds_first(la: LevelArrays, n: int):
    """(preds, pred_bytes, pred_data) with each slot's real predecessors
    moved to the front in table order, and the table cut to the most real
    predecessors of any slot; the rest of a row is the sentinel ``n``."""
    real = la.pred_data == 0                                 # (L, W, P)
    p_real = max(int(real.sum(axis=2).max(initial=0)), 1)
    idx = np.argsort(~real, axis=2, kind="stable")[..., :p_real]
    keep = np.take_along_axis(real, idx, axis=2)
    preds = np.where(keep, np.take_along_axis(la.preds, idx, axis=2), n)
    pbytes = np.where(keep, np.take_along_axis(la.pred_bytes, idx, axis=2),
                      0.0)
    return (preds.astype(np.int32), pbytes.astype(np.float32),
            (~keep).astype(np.float32))


def level_tensors(la: LevelArrays, device) -> LevelTensors:
    """Put ``la``'s tables on ``device``, repacked for the kernel (see
    :class:`LevelTensors`).  Once per graph, never per call."""
    n = int(la.order.shape[0])
    preds, pbytes, pdata = _real_preds_first(la, n)
    L, W, P = preds.shape
    D = la.dur.shape[2]
    real = la.nodes != n                  # pads trail each level's row
    S = int(real.sum())
    off_nodes, off_upre, off_preds, off_dur, words = level_record_offsets(
        L, S, P, D)
    upre = np.full((S, PRE), n, np.int32)
    upre[:, :min(P, PRE)] = preds[real][:, :PRE]
    records = np.zeros(words, np.int32)
    records[:L + 1] = np.concatenate([[0], np.cumsum(real.sum(axis=1))])
    records[off_nodes:off_nodes + S] = la.nodes[real]
    records[off_upre:off_upre + S * PRE] = upre.ravel()
    records[off_preds:off_preds + 2 * S * P] = np.stack(
        [preds[real], pbytes[real].view(np.int32)], axis=-1).ravel()
    records[off_dur:off_dur + S * D] = np.ascontiguousarray(
        la.dur[real], np.float32).view(np.int32).ravel()

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return LevelTensors(put(la.nodes), put(preds), put(la.dur), put(pbytes),
                        put(pdata), put(records),
                        np.asarray(la.nodes, np.int32), n, S)


class LevelPlan(NamedTuple):
    """One launch of ``csrc/levelsim.cu``.

    ``group`` lanes score one placement (a power of two ≥ W, at most 32),
    so a warp scores up to ``per_warp`` placements; a block scores
    ``per_block`` of them with ``warps`` warps (those past its placements
    only help fill shared memory), ``blocks`` in the grid; ``smem`` bytes of
    dynamic shared memory a block; ``queues`` where a placement's D·Q queue
    state lives (``registers`` or ``shared``).
    """

    route: str
    group: int
    per_warp: int
    per_block: int
    warps: int
    blocks: int
    smem: int
    queues: str


def level_smem(route: str, per_block: int, V: int, D: int, Q: int, S: int,
               table_words: int) -> int:
    """Dynamic shared memory of a block of ``per_block`` placements, in the
    order the kernel carves it: on ``staged`` the records, the finish
    vectors (V+1 floats each), the block's device rows (V ints each, plus up
    to three words that keep their 16-byte copies aligned) and each
    placement's precomputed half of its S slots (``STATIC_WORDS`` each);
    then inv_bw, lat and queue_init; then, where queues live in shared
    memory, D·Q floats a placement."""
    nbytes = 4 * _words16(2 * D * D + D * Q)
    if route == "staged":
        nbytes += 4 * (table_words + _words16(per_block * (V + 1))
                       + _words16(per_block * V + 4)
                       + per_block * S * STATIC_WORDS)
    if route == "general" or D * Q > REG_QUEUES:
        nbytes += 4 * per_block * D * Q
    return nbytes


@functools.lru_cache(maxsize=256)
def level_launch_plan(B: int, L: int, W: int, P: int, V: int, D: int,
                      Q: int, S: int) -> LevelPlan:
    """The launch ``level_makespan`` makes for B placements of a graph of V
    nodes whose (compacted) tables are L × W slots, S of them real, of P
    preds, on D devices of at most Q queues.

    - ``staged`` wherever it fits: the tables, each placement's finish
      vector, device row and precomputed slot halves live in shared memory,
      filled once per block.  The queue state is in registers when D·Q ≤
      ``REG_QUEUES``.
    - ``general`` otherwise (tables or finish vectors too large for shared
      memory): tables, finish vectors and device rows stay in device
      memory; only the constants and the queues are in shared memory.

    A block takes as few placements as spread the batch over the ``SMS``
    SMs (at most ``MAX_WARPS`` warps of them), fewer where shared memory
    runs out, and always ``MAX_WARPS`` warps: all of them fill its shared
    memory, those with placements then walk the levels.  Raises where not
    even the general route fits.
    """
    if min(B, L, W, P, V, D, Q, S) < 1:
        raise ValueError(f"level_launch_plan: every count must be positive; "
                         f"got B={B} L={L} W={W} P={P} V={V} D={D} Q={Q} "
                         f"S={S}")
    group = min(32, 1 << (W - 1).bit_length())
    per_warp = 32 // group
    want = min(MAX_WARPS * per_warp, _cdiv(B, SMS))
    words = level_record_offsets(L, S, P, D)[-1]
    for route in ROUTES:
        for per_block in range(want, 0, -1):
            smem = level_smem(route, per_block, V, D, Q, S, words)
            if smem <= SMEM_LIMIT:
                queues = ("registers" if route == "staged"
                          and D * Q <= REG_QUEUES else "shared")
                return LevelPlan(route, group, per_warp, per_block,
                                 MAX_WARPS, _cdiv(B, per_block), smem,
                                 queues)
    raise ValueError(f"level_launch_plan: D={D} x Q={Q} queues do not fit "
                     f"in shared memory")


def level_makespan_ref(lt: LevelTensors, placements: torch.Tensor,
                       queue_init: torch.Tensor, inv_bw: torch.Tensor,
                       lat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version → (finish (B, V+1) f32, transfer (B,) f32).

    Mirrors the reference kernel step for step: per level, the readiness of
    every slot at once (predecessor finish + bytes·inv_bw + lat, 0 for
    same-device and data preds; transfer terms summed in index order), then
    the level's slots retire in table order onto their device's first
    earliest-free queue.
    """
    B, n = placements.shape
    L, W = lt.nodes.shape
    P = lt.preds.shape[2]
    D, Q = queue_init.shape
    device = placements.device
    place_pad = torch.cat(
        [placements.long(), torch.zeros(B, 1, dtype=torch.long,
                                        device=device)], dim=1)   # (B, V+1)
    fin = torch.zeros(B, n + 1, dtype=torch.float32, device=device)
    qs = queue_init.to(torch.float32).expand(B, D, Q).clone()
    tr = torch.zeros(B, dtype=torch.float32, device=device)
    bidx = torch.arange(B, device=device)
    for l in range(L):
        nodes = lt.nodes[l].long()
        preds = lt.preds[l].long().reshape(-1)
        d_n = place_pad[:, nodes]                                   # (B, W)
        pd = place_pad[:, preds].reshape(B, W, P)
        fpred = fin[:, preds].reshape(B, W, P)
        dcol = d_n[:, :, None].expand(B, W, P)
        tx = torch.where((lt.pred_data[l] > 0) | (pd == dcol),
                         torch.zeros((), device=device),
                         lt.pred_bytes[l] * inv_bw[pd, dcol] + lat[pd, dcol])
        ready = (fpred + tx).amax(dim=2).clamp_min(0.0)             # (B, W)
        txsum = tx[..., 0]
        for p in range(1, P):
            txsum = txsum + tx[..., p]
        dur_n = torch.gather(lt.dur[l].expand(B, W, D), 2,
                             d_n[:, :, None])[..., 0]               # (B, W)
        for w in range(W):
            v = int(lt.nodes_host[l, w])
            if v == n:
                continue
            d = d_n[:, w]
            q_rows = qs[bidx, d]                                    # (B, Q)
            q = q_rows.argmin(dim=1)                                # first min
            q_free = q_rows.gather(1, q[:, None])[:, 0]
            f = torch.maximum(ready[:, w], q_free) + dur_n[:, w]
            fin[:, v] = f
            qs[bidx, d, q] = f
            tr = tr + txsum[:, w]
    return fin, tr


@functools.cache
def _lib():
    from ._build import library
    fn = library("levelsim").level_makespan_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(lt: LevelTensors, B: int, Q: int):
    """(plan, its ``params`` array, the array's address) of a launch for B
    placements and Q queues on ``lt``'s tables; made once, kept in ``lt``."""
    hit = lt.launches.get((B, Q))
    if hit is None:
        L, W, P, D = lt.shape
        V, S = lt.num_nodes, lt.slots
        plan = level_launch_plan(B, L, W, P, V, D, Q, S)
        off_nodes, off_upre, off_preds, off_dur, words = lt.offsets
        values = dict(table_words=words, off_nodes=off_nodes,
                      off_upre=off_upre, off_preds=off_preds,
                      off_dur=off_dur, L=L, W=W, P=P, V=V, D=D, Q=Q, S=S,
                      route=ROUTES.index(plan.route), group=plan.group,
                      per_block=plan.per_block, warps=plan.warps)
        params = (ctypes.c_int * len(PARAMS))(*(values[k] for k in PARAMS))
        hit = lt.launches[(B, Q)] = (plan, params, ctypes.addressof(params))
    return hit


def level_makespan(lt: LevelTensors, placements: torch.Tensor,
                   queue_init: torch.Tensor, inv_bw: torch.Tensor,
                   lat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score B placements → (finish (B, V+1) f32, transfer (B,) f32).

    ``placements``: (B, V) device ids in [0, D); ``queue_init``: (D, Q) with
    +inf at masked queue slots; ``inv_bw``/``lat``: (D, D) link constants.
    Finish times of data ops (and the V sentinel slot) are 0.  CUDA tensors
    launch ``csrc/levelsim.cu`` on the route ``level_launch_plan`` gives;
    CPU tensors take ``level_makespan_ref``.  The tables were checked when
    ``lt`` was built, so only the placements and the platform's tensors are
    checked here.  The caller validates device ids (the kernel indexes with
    them).
    """
    if placements.is_cpu:
        return level_makespan_ref(lt, placements, queue_init, inv_bw, lat)
    if not placements.is_cuda:
        raise ValueError(f"level_makespan takes CPU or CUDA tensors; got "
                         f"{placements.device}")
    V = lt.num_nodes
    D = lt.shape[3]
    dev = placements.get_device()
    if placements.dtype != torch.int32 or placements.ndim != 2 \
            or placements.shape[1] != V or not placements.is_contiguous() \
            or lt.nodes.get_device() != dev:
        raise ValueError(f"level_makespan: placements must be a contiguous "
                         f"int32 (B, {V}) tensor on the tables' device "
                         f"{lt.device}; got {placements.dtype} "
                         f"{tuple(placements.shape)} on {placements.device}")
    Q = queue_init.shape[-1]
    for name, t, shape in (("queue_init", queue_init, (D, Q)),
                           ("inv_bw", inv_bw, (D, D)), ("lat", lat, (D, D))):
        if t.get_device() != dev or t.dtype != torch.float32 \
                or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"level_makespan: {name} must be a contiguous "
                             f"float32 tensor of shape {shape} on "
                             f"{placements.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    B = placements.shape[0]
    finish = torch.empty(B, V + 1, dtype=torch.float32,
                         device=placements.device)
    transfer = torch.empty(B, dtype=torch.float32, device=placements.device)
    if B == 0:
        return finish, transfer
    plan, _, params = _launch(lt, B, Q)
    err = _lib()(lt.records.data_ptr(), params, placements.data_ptr(),
                 inv_bw.data_ptr(), lat.data_ptr(), queue_init.data_ptr(),
                 finish.data_ptr(), transfer.data_ptr(), B,
                 torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"level_makespan kernel launch failed "
                           f"({plan.route}): CUDA error {err}")
    level_makespan.launches += 1
    level_makespan.route_launches[plan.route] += 1
    return finish, transfer


level_makespan.launches = 0
#: launches per route of ``level_launch_plan``
level_makespan.route_launches = dict.fromkeys(ROUTES, 0)
