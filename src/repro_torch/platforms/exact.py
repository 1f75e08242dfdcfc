"""Exact DP placement for series-parallel-decomposable graphs.

Port of ``repro/platforms/exact.py`` by copy (numpy): the same placements
and, through the port's own cost model, the same latencies bit for bit.

Tarnawski et al. ("Efficient Algorithms for Device Placement of DNN Graph
Operators") show that placement is polynomial on graphs that decompose into
chains and series-parallel compositions.  This module implements that
yardstick for the repo's cost model:

* :func:`sp_decompose` — two-terminal series-parallel recognition by edge
  reduction (series-contract degree-(1,1) nodes, parallel-merge duplicate
  edges, until a single source→sink edge remains; ``None`` otherwise).
  Chains are the degenerate all-series case.
* :func:`dp_optimal` — per-edge (D, D) DP tables over the reduction tree:
  series composition takes a min over the middle device, parallel
  composition an elementwise max over independent branches.  The objective
  is the **contention-free makespan** — the longest source→sink path of op
  durations plus cross-device transfers, exactly what ``simulate`` computes
  whenever every device's ``parallel_queues`` covers the DAG's width.  On
  such platforms the returned placement is provably optimal (asserted
  against brute force in tests/test_platforms.py).
* :func:`hybrid_refine` — the DP applied as a *local* pass: the interiors
  of maximal linear segments are re-placed optimally given the RL-chosen
  boundary devices, and the refinement is kept only when the full
  list-schedule simulation actually improves (queue contention can differ
  from the path objective on branchy graphs, so the guard is mandatory).

Costs reuse the cost model's own ``_op_time`` / ``op_class`` /
``_eff_hint`` entry points, so DP durations match ``simulate`` bit for bit.
Memory capacities are ignored by the DP (its optimality claim assumes no
binding OOM constraint); callers can check ``simulate(...).oom`` after.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..core.costmodel import (Platform, _eff_hint, _op_time, op_class,
                              simulate)
from ..core.graph import CompGraph

__all__ = ["DPResult", "sp_decompose", "dp_optimal", "hybrid_refine"]


class DPResult(NamedTuple):
    """An exact-DP placement and its scores."""

    placement: np.ndarray    # (V,) int64 device per node
    latency: float           # simulate() makespan of the placement (seconds)
    bound: float             # DP objective: contention-free longest path
    oom: bool                # whether the placement OOMs under simulate()


def _durations(g: CompGraph, platform: Platform) -> np.ndarray:
    """(V, D) per-op durations, matching the simulator's cost entry point."""
    flops, byts = g.flops(), g.bytes_out()
    out = np.zeros((g.num_nodes, platform.num_devices))
    for v, node in enumerate(g.nodes):
        cls = op_class(node.op_type)
        for d, dev in enumerate(platform.devices):
            out[v, d] = _op_time(flops[v], byts[v], dev, cls,
                                 _eff_hint(node, dev))
    return out


def _tx_table(g: CompGraph, platform: Platform, u: int) -> np.ndarray:
    """(D, D) transfer cost of u's output from device i to device j."""
    ndev = platform.num_devices
    if op_class(g.nodes[u].op_type) == "data":
        return np.zeros((ndev, ndev))
    byts = float(g.bytes_out()[u])
    with np.errstate(divide="ignore", invalid="ignore"):
        tx = byts / np.asarray(platform.link_bw, np.float64) \
            + np.asarray(platform.link_latency, np.float64)
    np.fill_diagonal(tx, 0.0)
    return tx


# Reduction-tree nodes.  A table entry M[da, db] is the minimal (over
# internal placements) longest a→b path cost through the subgraph —
# internal op durations plus every transfer, *excluding* the two endpoint
# durations (those are added once at the very end).
@dataclasses.dataclass
class _Edge:
    u: int
    v: int
    table: np.ndarray                       # (D, D)
    recon: Tuple                            # reconstruction tree


def sp_decompose(g: CompGraph) -> Optional[List["_Edge"]]:
    """Reduce ``g`` to a single two-terminal edge; ``None`` if not SP.

    Returns the surviving edge list (length 1 on success) whose ``recon``
    tree records every series contraction — enough to rebuild the full
    placement once terminal devices are chosen.  The tables produced here
    are *structural* (built with a 1-device dummy cost); :func:`dp_optimal`
    re-runs the reduction with real costs.  Exposed separately so callers
    can cheaply test decomposability.
    """
    edges = _reduce(g, np.zeros((g.num_nodes, 1)),
                    lambda u: np.zeros((1, 1)))
    return edges


def _reduce(g: CompGraph, dur: np.ndarray, tx_of) -> Optional[List[_Edge]]:
    n = g.num_nodes
    if n == 0:
        return None
    indeg = np.zeros(n, int)
    outdeg = np.zeros(n, int)
    for s, d in g.edges:
        indeg[int(d)] += 1
        outdeg[int(s)] += 1
    sources = np.flatnonzero(indeg == 0)
    sinks = np.flatnonzero(outdeg == 0)
    if len(sources) != 1 or len(sinks) != 1:
        return None
    s, t = int(sources[0]), int(sinks[0])
    if n == 1:
        return [_Edge(s, t, np.zeros_like(tx_of(s)), ("leaf",))]

    edges: List[_Edge] = [
        _Edge(int(a), int(b), tx_of(int(a)), ("leaf",))
        for a, b in g.edges]

    def degrees():
        ind: Dict[int, int] = {}
        outd: Dict[int, int] = {}
        for e in edges:
            outd[e.u] = outd.get(e.u, 0) + 1
            ind[e.v] = ind.get(e.v, 0) + 1
        return ind, outd

    changed = True
    while changed and len(edges) > 1:
        changed = False
        # Parallel: merge duplicate (u, v) pairs — independent branches, so
        # the minimal max is the elementwise max of per-branch minima.
        by_pair: Dict[Tuple[int, int], List[_Edge]] = {}
        for e in edges:
            by_pair.setdefault((e.u, e.v), []).append(e)
        merged: List[_Edge] = []
        for (u, v), grp in by_pair.items():
            while len(grp) > 1:
                a, b = grp.pop(), grp.pop()
                grp.append(_Edge(u, v, np.maximum(a.table, b.table),
                                 ("parallel", a.recon, b.recon)))
                changed = True
            merged.append(grp[0])
        edges = merged
        # Series: contract an internal node with exactly one in- and one
        # out-edge; min over its device, recording the argmin for rebuild.
        ind, outd = degrees()
        for w in list(ind):
            if w in (s, t) or ind.get(w) != 1 or outd.get(w) != 1:
                continue
            e1 = next(e for e in edges if e.v == w)
            e2 = next(e for e in edges if e.u == w)
            if e1.u == w:                       # self-loop guard (non-DAG)
                continue
            # M[da, db] = min_dw  e1[da, dw] + dur(w, dw) + e2[dw, db]
            mid = e1.table[:, :, None] + dur[w][None, :, None] \
                + e2.table[None, :, :]
            arg = np.argmin(mid, axis=1)
            table = np.min(mid, axis=1)
            edges = [e for e in edges if e is not e1 and e is not e2]
            edges.append(_Edge(e1.u, e2.v, table,
                               ("series", w, arg, e1.recon, e2.recon)))
            changed = True
            break                               # degrees changed; rescan
    if len(edges) != 1 or edges[0].u != s or edges[0].v != t:
        return None
    return edges


def _assign(recon: Tuple, u: int, v: int, du: int, dv: int,
            placement: np.ndarray) -> None:
    kind = recon[0]
    if kind == "leaf":
        return
    if kind == "parallel":
        _assign(recon[1], u, v, du, dv, placement)
        _assign(recon[2], u, v, du, dv, placement)
        return
    _, w, arg, r1, r2 = recon
    dw = int(arg[du, dv])
    placement[w] = dw
    _assign(r1, u, w, du, dw, placement)
    _assign(r2, w, v, dw, dv, placement)


def dp_optimal(g: CompGraph, platform: Platform) -> Optional[DPResult]:
    """Exact DP placement for a series-parallel ``g``; ``None`` if not SP.

    The DP objective (``bound``) is the contention-free makespan; it equals
    the ``simulate`` makespan — and the placement is provably optimal —
    whenever each device's ``parallel_queues`` covers the graph's width.
    """
    dur = _durations(g, platform)
    edges = _reduce(g, dur, lambda u: _tx_table(g, platform, u))
    if edges is None:
        return None
    e = edges[0]
    s, t = e.u, e.v
    placement = np.zeros(g.num_nodes, dtype=np.int64)
    if s == t:                                  # single-node graph
        ds = int(np.argmin(dur[s]))
        placement[s] = ds
        bound = float(dur[s, ds])
    else:
        total = dur[s][:, None] + e.table + dur[t][None, :]
        ds, dt = np.unravel_index(int(np.argmin(total)), total.shape)
        placement[s], placement[t] = int(ds), int(dt)
        _assign(e.recon, s, t, int(ds), int(dt), placement)
        bound = float(total[ds, dt])
    res = simulate(g, placement, platform)
    return DPResult(placement, float(res.latency), bound, bool(res.oom))


def _linear_segments(g: CompGraph) -> List[Tuple[Optional[int], List[int],
                                                 Optional[int]]]:
    """Maximal runs of degree-(1,1) nodes → (pred-boundary, run, succ-boundary).

    Boundaries are the (branchy or terminal) nodes just outside the run;
    ``None`` when the run starts at a source / ends at a sink.
    """
    n = g.num_nodes
    preds: List[List[int]] = [[] for _ in range(n)]
    succs: List[List[int]] = [[] for _ in range(n)]
    for a, b in g.edges:
        preds[int(b)].append(int(a))
        succs[int(a)].append(int(b))
    interior = [len(preds[v]) == 1 and len(succs[v]) == 1 for v in range(n)]
    seen = [False] * n
    out = []
    for v in range(n):
        if not interior[v] or seen[v]:
            continue
        run = [v]
        seen[v] = True
        while True:                              # walk back
            u = preds[run[0]][0]
            if interior[u] and not seen[u]:
                seen[u] = True
                run.insert(0, u)
            else:
                break
        while True:                              # walk forward
            w = succs[run[-1]][0]
            if interior[w] and not seen[w]:
                seen[w] = True
                run.append(w)
            else:
                break
        b0 = preds[run[0]][0] if preds[run[0]] else None
        b1 = succs[run[-1]][0] if succs[run[-1]] else None
        out.append((b0, run, b1))
    return out


def hybrid_refine(g: CompGraph, placement: Sequence[int],
                  platform: Platform) -> DPResult:
    """DP-refine the linear segments of an RL placement; keep it only if
    the full simulation improves.

    Every maximal chain run is re-placed by an exact chain DP with its
    boundary devices held at the RL choice (the Tarnawski insight applied
    locally: chains are always DP-solvable even when the surrounding graph
    is not).  Because the DP objective ignores queue contention between
    parallel branches, the refined placement is only *kept* when
    ``simulate`` confirms the makespan improved; otherwise the original is
    returned unchanged.
    """
    placement = np.asarray(placement, dtype=np.int64).copy()
    base = simulate(g, placement, platform)
    dur = _durations(g, platform)
    tx_cache: Dict[int, np.ndarray] = {}

    def tx(u: int) -> np.ndarray:
        if u not in tx_cache:
            tx_cache[u] = _tx_table(g, platform, u)
        return tx_cache[u]

    refined = placement.copy()
    for b0, run, b1 in _linear_segments(g):
        k, ndev = len(run), platform.num_devices
        f = np.full((k, ndev), np.inf)
        arg = np.zeros((k, ndev), dtype=np.int64)
        first = run[0]
        if b0 is None:
            f[0] = dur[first]
        else:
            f[0] = tx(b0)[int(refined[b0])] + dur[first]
        for i in range(1, k):
            prev, cur = run[i - 1], run[i]
            cand = f[i - 1][:, None] + tx(prev) + dur[cur][None, :]
            arg[i] = np.argmin(cand, axis=0)
            f[i] = np.min(cand, axis=0)
        last = run[-1]
        if b1 is None:
            d = int(np.argmin(f[k - 1]))
        else:
            d = int(np.argmin(f[k - 1] + tx(last)[:, int(refined[b1])]))
        for i in range(k - 1, -1, -1):
            refined[run[i]] = d
            if i:
                d = int(arg[i, d])
    res = simulate(g, refined, platform)
    if res.latency < base.latency and not (res.oom and not base.oom):
        return DPResult(refined, float(res.latency), float(res.latency),
                        bool(res.oom))
    return DPResult(placement, float(base.latency), float(base.latency),
                    bool(base.oom))
