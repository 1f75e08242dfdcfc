"""Seedable synthetic DAG families — the corpus-scale workload generators.

Port of ``repro/graphs/synthetic.py`` by copy: the same seed gives the same
graph, node for node and edge for edge.

The paper trains on three hand-written graphs; a policy that generalizes
(GDP, Placeto) needs *dozens* of heterogeneous DAGs.  These families cover
the structural regimes the Table-2 graphs span, with size/width/op-mix
knobs so a corpus can sweep them:

* ``layered``          — width-W layers, edges between consecutive layers
                         (optionally skipping) — the ResNet/BERT regime of
                         mostly-sequential stages with bounded parallelism.
* ``series_parallel``  — recursive series/parallel composition — balanced
                         fork/join nests with no cross links.
* ``branch_join``      — chained fan-out/fan-in blocks with per-branch
                         chains — the Inception regime (wide independent
                         branches contending for device queues).

Every generator is a pure function of its arguments (all randomness from
``numpy.random.default_rng(seed)``), so a corpus spec reproduces the same
graphs on any host — the property checkpoint resume and the corpus
fingerprint rely on.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import CompGraph

__all__ = ["layered_dag", "series_parallel_dag", "branch_join_dag",
           "SYNTHETIC_FAMILIES", "DEFAULT_OP_MIX"]

#: op-type mix (type → weight) — spans the cost model's op classes: gemm
#: (MatMul), conv (Convolution), and assorted eltwise ops.
DEFAULT_OP_MIX: Tuple[Tuple[str, float], ...] = (
    ("MatMul", 3.0), ("Convolution", 2.0), ("ReLU", 2.0),
    ("Add", 2.0), ("Concat", 1.0), ("SoftMax", 1.0),
)


def _mix_arrays(op_mix) -> Tuple[Sequence[str], np.ndarray]:
    types = [t for t, _ in op_mix]
    w = np.asarray([float(v) for _, v in op_mix])
    return types, w / w.sum()


def _add_random_op(g: CompGraph, rng: np.random.Generator, name: str,
                   inputs: Sequence[str], types, probs,
                   flops_scale: float) -> str:
    op = types[int(rng.choice(len(types), p=probs))]
    elems = int(rng.integers(16, 4096))
    flops = float(rng.integers(1, 1_000_000)) * flops_scale
    g.add_op(name, op, list(inputs), (1, elems), flops=flops,
             bytes_out=float(elems * 4))
    return name


def layered_dag(num_layers: int = 8, width: int = 4, *, seed: int = 0,
                p_skip: float = 0.1,
                op_mix=DEFAULT_OP_MIX, flops_scale: float = 1.0,
                name: Optional[str] = None) -> CompGraph:
    """Width-``width`` layers; each node draws 1–3 parents from the previous
    layer, plus skip edges from earlier layers with prob ``p_skip``."""
    if num_layers < 1 or width < 1:
        raise ValueError("layered_dag needs num_layers >= 1 and width >= 1")
    rng = np.random.default_rng(seed)
    types, probs = _mix_arrays(op_mix)
    g = CompGraph(name or f"layered_L{num_layers}w{width}s{seed}")
    g.add_op("input", "Parameter", [], (1, 64), flops=0.0, bytes_out=256.0)
    prev = ["input"]
    all_prior = ["input"]
    for li in range(num_layers):
        cur = []
        for wi in range(width):
            k = int(rng.integers(1, min(3, len(prev)) + 1))
            parents = list(rng.choice(prev, size=k, replace=False))
            for earlier in all_prior[:-len(prev)] or []:
                if rng.random() < p_skip:
                    parents.append(earlier)
            nm = _add_random_op(g, rng, f"l{li}_n{wi}", sorted(set(parents)),
                                types, probs, flops_scale)
            cur.append(nm)
        all_prior.extend(cur)
        prev = cur
    g.add_op("output", "Concat", prev, (1, 64 * len(prev)), flops=0.0,
             bytes_out=float(256 * len(prev)))
    g.validate_acyclic()
    return g


def series_parallel_dag(target_nodes: int = 24, *, seed: int = 0,
                        op_mix=DEFAULT_OP_MIX, flops_scale: float = 1.0,
                        name: Optional[str] = None) -> CompGraph:
    """Recursive series/parallel composition down to single-op units."""
    if target_nodes < 1:
        raise ValueError("series_parallel_dag needs target_nodes >= 1")
    rng = np.random.default_rng(seed)
    types, probs = _mix_arrays(op_mix)
    g = CompGraph(name or f"sp_{target_nodes}s{seed}")
    g.add_op("input", "Parameter", [], (1, 64), flops=0.0, bytes_out=256.0)
    uid = [0]

    def unit(src: str) -> str:
        uid[0] += 1
        return _add_random_op(g, rng, f"u{uid[0]}", [src], types, probs,
                              flops_scale)

    def compose(src: str, budget: int) -> str:
        if budget <= 1:
            return unit(src)
        if rng.random() < 0.5:          # series: left then right
            left = int(rng.integers(1, budget))
            return compose(compose(src, left), budget - left)
        # parallel: 2–3 branches joined by an Add/Concat unit
        nb = int(rng.integers(2, 4))
        budget -= 1                      # reserve the join node
        splits = np.sort(rng.choice(np.arange(1, budget),
                                    size=min(nb - 1, budget - 1),
                                    replace=False))
        parts = np.diff(np.concatenate([[0], splits, [budget]]))
        outs = [compose(src, int(p)) for p in parts if p > 0]
        uid[0] += 1
        join = f"j{uid[0]}"
        g.add_op(join, "Add" if rng.random() < 0.5 else "Concat",
                 outs, (1, 64), flops=64.0, bytes_out=256.0)
        return join

    compose("input", target_nodes)
    g.validate_acyclic()
    return g


def branch_join_dag(num_blocks: int = 3, branches: int = 4, depth: int = 2, *,
                    seed: int = 0, op_mix=DEFAULT_OP_MIX,
                    flops_scale: float = 1.0,
                    name: Optional[str] = None) -> CompGraph:
    """Inception-style: chained blocks of ``branches`` independent chains of
    ``depth`` ops, each block joined by a Concat."""
    if min(num_blocks, branches, depth) < 1:
        raise ValueError("branch_join_dag needs all knobs >= 1")
    rng = np.random.default_rng(seed)
    types, probs = _mix_arrays(op_mix)
    g = CompGraph(name or f"bj_{num_blocks}x{branches}x{depth}s{seed}")
    g.add_op("input", "Parameter", [], (1, 64), flops=0.0, bytes_out=256.0)
    prev = "input"
    for bi in range(num_blocks):
        outs = []
        for br in range(branches):
            src = prev
            for d in range(depth):
                src = _add_random_op(g, rng, f"b{bi}_br{br}_d{d}", [src],
                                     types, probs, flops_scale)
            outs.append(src)
        prev = f"b{bi}_join"
        g.add_op(prev, "Concat", outs, (1, 64 * branches), flops=0.0,
                 bytes_out=float(256 * branches))
    g.validate_acyclic()
    return g


#: family name → generator, the knobs a corpus spec can set per family.
SYNTHETIC_FAMILIES: Dict[str, object] = {
    "layered": layered_dag,
    "series_parallel": series_parallel_dag,
    "branch_join": branch_join_dag,
}
