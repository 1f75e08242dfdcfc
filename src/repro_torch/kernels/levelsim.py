"""Level-parallel makespan kernel — the ``level`` simulator backend's scorer.

Port of ``repro/kernels/levelsim.py``.  One call scores B placements of one
graph under the **level-major** list schedule: nodes retire level by level
(ties in the base topological order), each node waits for its predecessors'
finish times plus the cross-device transfer cost, then takes the
earliest-free queue of its device (first minimum).  Build the tables from
``sim_arrays(g, platform, schedule="level")`` and compare against
``simulate(g, p, platform, order=sa.order)``.

"data"-class ops (weights/inputs resident on the consumer device) never
enter the tables: they cost nothing, their finish time stays 0, and their
out-edges pay no transfer.

``level_makespan`` launches the CUDA kernel ``csrc/levelsim.cu`` on CUDA
tensors and runs the plain PyTorch version ``level_makespan_ref`` on CPU
tensors.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["LevelArrays", "build_level_arrays", "LevelTensors",
           "level_tensors", "level_makespan_ref", "level_makespan"]


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
    n = order.shape[0]
    p_max = sa.preds.shape[1]
    ndev = sa.op_time.shape[0]

    # preds are stored per order-position; re-index them per node id.  Rows
    # of padded arrays may carry the *unpadded* sentinel — every sentinel
    # points at some data slot, so they are interchangeable here.
    pred_by_node = np.full((n + 1, p_max), n, dtype=np.int64)
    pred_by_node[order] = np.asarray(sa.preds, np.int64)

    lvl_order = order[np.argsort(levels[order], kind="stable")]
    sched = [int(v) for v in lvl_order if not is_data[v]]
    by_level: dict = {}
    for v in sched:
        by_level.setdefault(int(levels[v]), []).append(v)
    rows = [by_level[k] for k in sorted(by_level)]

    L = len(rows)
    W = max((len(r) for r in rows), default=1) or 1
    nodes = np.full((max(L, 1), W), n, dtype=np.int32)
    preds = np.full((max(L, 1), W, p_max), n, dtype=np.int32)
    dur = np.zeros((max(L, 1), W, ndev), dtype=np.float32)
    pbytes = np.zeros((max(L, 1), W, p_max), dtype=np.float32)
    pdata = np.ones((max(L, 1), W, p_max), dtype=np.float32)
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
                       order=lvl_order.astype(np.int32))


class LevelTensors(NamedTuple):
    """:class:`LevelArrays` tables on one device, ready for a launch.

    ``nodes_host`` keeps the (L, W) node table on the host, where the plain
    version reads its pad slots without a device round trip.
    """

    nodes: torch.Tensor       # (L, W) i32
    preds: torch.Tensor       # (L, W, P) i32
    dur: torch.Tensor         # (L, W, D) f32
    pred_bytes: torch.Tensor  # (L, W, P) f32
    pred_data: torch.Tensor   # (L, W, P) f32
    nodes_host: np.ndarray    # (L, W) i32


def level_tensors(la: LevelArrays, device) -> LevelTensors:
    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return LevelTensors(put(la.nodes), put(la.preds), put(la.dur),
                        put(la.pred_bytes), put(la.pred_data),
                        np.asarray(la.nodes, np.int32))


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


def _lib():
    from ._build import library
    lib = library("levelsim")
    fn = lib.level_makespan_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
    return fn


def level_makespan(lt: LevelTensors, placements: torch.Tensor,
                   queue_init: torch.Tensor, inv_bw: torch.Tensor,
                   lat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score B placements → (finish (B, V+1) f32, transfer (B,) f32).

    ``placements``: (B, V) device ids in [0, D); ``queue_init``: (D, Q) with
    +inf at masked queue slots; ``inv_bw``/``lat``: (D, D) link constants.
    Finish times of data ops (and the V sentinel slot) are 0.  CUDA tensors
    launch ``csrc/levelsim.cu``; CPU tensors take ``level_makespan_ref``.
    The caller validates device ids (the kernel indexes with them).
    """
    if placements.device.type == "cpu":
        return level_makespan_ref(lt, placements, queue_init, inv_bw, lat)
    if placements.device.type != "cuda":
        raise ValueError(f"level_makespan takes CPU or CUDA tensors; got "
                         f"{placements.device}")
    B, n = placements.shape
    L, W = lt.nodes.shape
    P = lt.preds.shape[2]
    D, Q = queue_init.shape
    ins = dict(nodes=(lt.nodes, torch.int32, (L, W)),
               preds=(lt.preds, torch.int32, (L, W, P)),
               dur=(lt.dur, torch.float32, (L, W, D)),
               pred_bytes=(lt.pred_bytes, torch.float32, (L, W, P)),
               pred_data=(lt.pred_data, torch.float32, (L, W, P)),
               placements=(placements, torch.int32, (B, n)),
               inv_bw=(inv_bw, torch.float32, (D, D)),
               lat=(lat, torch.float32, (D, D)),
               queue_init=(queue_init, torch.float32, (D, Q)))
    for name, (t, dtype, shape) in ins.items():
        if t.device != placements.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"level_makespan: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {placements.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    finish = torch.empty(B, n + 1, dtype=torch.float32,
                         device=placements.device)
    transfer = torch.empty(B, dtype=torch.float32, device=placements.device)
    if B == 0:
        return finish, transfer
    err = _lib()(*(t.data_ptr() for t, _, _ in ins.values()),
                 finish.data_ptr(), transfer.data_ptr(),
                 B, L, W, P, n, D, Q,
                 torch.cuda.current_stream(placements.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"level_makespan kernel launch failed: CUDA "
                           f"error {err}")
    level_makespan.launches += 1
    return finish, transfer


level_makespan.launches = 0
