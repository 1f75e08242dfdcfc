"""Feature extraction (paper §2.3).

Produces the initial node feature matrix X^(0) as the concatenation of

  [ op-type one-hot (Eq. 3) | padded output shape | in-degree one-hot
    | out-degree one-hot | fractal dimension (Eq. 4) | positional encoding (Eq. 5) ]

with ablation switches matching paper Table 3:
  * ``use_structural``  — in/out-degree one-hots + fractal dimension
  * ``use_output_shape``— padded output-shape vector
  * ``use_node_id``     — topological positional encoding
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import shortest_path

from .graph import CompGraph, topological_order

__all__ = [
    "FeatureConfig",
    "fractal_dimension",
    "positional_encoding",
    "one_hot",
    "extract_features",
    "GraphArrays",
    "GraphArraysBatch",
    "batch_graph_arrays",
    "batch_graph_arrays_bucketed",
    "shared_feature_config",
    "check_feature_compat",
]


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    d_pos: int = 16                 # sinusoidal positional width (Eq. 5)
    max_shape_rank: int = 6         # padded output-shape vector length
    use_structural: bool = True     # Table 3: "w/o graph structural features"
    use_output_shape: bool = True   # Table 3: "w/o output shape"
    use_node_id: bool = True        # Table 3: "w/o node ID"
    log_shape: bool = True          # log1p-compress raw shape dims
    # Vocabularies may be shared across graphs so that a policy trained on one
    # benchmark sees consistent feature layout on another.
    op_vocab: Optional[Tuple[str, ...]] = None
    in_deg_vocab: Optional[Tuple[int, ...]] = None
    out_deg_vocab: Optional[Tuple[int, ...]] = None


def one_hot(values: Sequence, vocab: Sequence) -> np.ndarray:
    """Eq. 3 — one-hot encode ``values`` against ``vocab`` (unknown → zeros)."""
    lookup = {v: i for i, v in enumerate(vocab)}
    out = np.zeros((len(values), len(vocab)), dtype=np.float32)
    for r, v in enumerate(values):
        idx = lookup.get(v)
        if idx is not None:
            out[r, idx] = 1.0
    return out


def _bfs_distances(g: CompGraph) -> np.ndarray:
    """All-pairs hop distances over the *undirected* skeleton (mass–radius
    analysis in complex-network fractal literature uses undirected balls)."""
    n = g.num_nodes
    e = g.edges
    if len(e) == 0:
        return np.full((n, n), np.inf)
    data = np.ones(len(e), dtype=np.float32)
    adj = csr_matrix((data, (e[:, 0], e[:, 1])), shape=(n, n))
    return shortest_path(adj, method="D", directed=False, unweighted=True)


def fractal_dimension(g: CompGraph,
                      dist: Optional[np.ndarray] = None) -> np.ndarray:
    """Eq. 4 — per-node fractal dimension from mass–radius regression.

    For node v with reachable distances {r_1..r_m} and mass N(v, r_k) = number
    of nodes within r_k, D(v) is the least-squares slope of
    log N(v, r) against log r.  Nodes with <2 distinct radii get D=0.
    """
    if dist is None:
        dist = _bfs_distances(g)
    n = g.num_nodes
    out = np.zeros(n, dtype=np.float32)
    for v in range(n):
        dv = dist[v]
        dv = dv[np.isfinite(dv) & (dv > 0)]
        if dv.size == 0:
            continue
        radii = np.unique(dv)
        if radii.size < 2:
            continue
        mass = np.array([(dv <= r).sum() for r in radii], dtype=np.float64)
        lr = np.log(radii)
        lm = np.log(mass)
        lr_c = lr - lr.mean()
        denom = float((lr_c ** 2).sum())
        if denom <= 0:
            continue
        out[v] = float((lr_c * (lm - lm.mean())).sum() / denom)
    return out


def positional_encoding(pos: np.ndarray, d_pos: int) -> np.ndarray:
    """Eq. 5 — sinusoidal encoding of the topological position."""
    assert d_pos % 2 == 0, "d_pos must be even"
    pos = np.asarray(pos, dtype=np.float64)[:, None]          # (V, 1)
    i = np.arange(d_pos // 2, dtype=np.float64)[None, :]      # (1, d/2)
    angles = pos / np.power(10000.0, 2.0 * i / d_pos)
    pe = np.zeros((pos.shape[0], d_pos), dtype=np.float32)
    pe[:, 0::2] = np.sin(angles)
    pe[:, 1::2] = np.cos(angles)
    return pe


def _shape_features(shapes: List[Tuple[int, ...]], rank: int,
                    log_compress: bool) -> np.ndarray:
    out = np.zeros((len(shapes), rank), dtype=np.float32)
    for r, s in enumerate(shapes):
        s = tuple(s)[-rank:]
        for k, dim in enumerate(s):
            out[r, rank - len(s) + k] = float(dim)
    if log_compress:
        out = np.log1p(out)
    return out


@dataclasses.dataclass
class GraphArrays:
    """Dense, jit-friendly view of one graph + its features.

    Everything HSDAG's tensor side needs: features, adjacency, edge list and the
    topological order used for positional ids.
    """

    x: np.ndarray                 # (V, d) float32 — X^(0)
    adj: np.ndarray               # (V, V) float32 — A
    edges: np.ndarray             # (E, 2) int32
    topo_pos: np.ndarray          # (V,) int32 — id(v) per §2.3
    flops: np.ndarray             # (V,) float64
    bytes_out: np.ndarray         # (V,) float64
    op_type_ids: np.ndarray       # (V,) int32 (into the op vocab)
    feature_slices: Dict[str, slice]

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])


@dataclasses.dataclass
class GraphArraysBatch:
    """G :class:`GraphArrays` padded/stacked to a common (G, V_max) shape.

    The encoder-side twin of ``costmodel.SimArraysBatch``: one policy can run
    batched over the graph axis because every graph shares the feature width
    (build the per-graph arrays with one FeatureConfig whose vocabularies
    span every graph) and the
    node/edge axes are padded to the batch maximum.  Pad nodes carry zero
    features and no adjacency; pad edges are (0, 0) with ``edge_mask`` False —
    the GPN/policy mask them out of scores, components and log-probs.
    """

    x: np.ndarray            # (G, V_max, d) float32 — zero rows at pad slots
    adj: np.ndarray          # (G, V_max, V_max) float32
    edges: np.ndarray        # (G, E_max, 2) int32 — (0, 0) at pad slots
    node_mask: np.ndarray    # (G, V_max) bool
    edge_mask: np.ndarray    # (G, E_max) bool
    num_nodes: np.ndarray    # (G,) int32
    num_edges: np.ndarray    # (G,) int32

    @property
    def num_graphs(self) -> int:
        return int(self.x.shape[0])

    @property
    def max_nodes(self) -> int:
        return int(self.x.shape[1])

    @property
    def padded(self) -> bool:
        """True when any graph actually needs its masks (unequal sizes)."""
        return not (bool(self.node_mask.all()) and bool(self.edge_mask.all()))


def shared_feature_config(graphs: Sequence[CompGraph],
                          base: FeatureConfig = FeatureConfig()
                          ) -> FeatureConfig:
    """A FeatureConfig whose vocabularies span every graph in ``graphs``.

    Cross-graph training needs one feature layout: the op-type / degree
    one-hots must index into shared vocabularies or the same column means
    different things on different graphs (and widths disagree).  Held-out
    graphs evaluated zero-shot must be featurized with this same config.
    """
    ops, in_deg, out_deg = set(), set(), set()
    for g in graphs:
        ops.update(g.op_types())
        in_deg.update(g.in_degrees().tolist())
        out_deg.update(g.out_degrees().tolist())
    return dataclasses.replace(
        base,
        op_vocab=tuple(sorted(ops)),
        in_deg_vocab=tuple(sorted(in_deg)),
        out_deg_vocab=tuple(sorted(out_deg)))


def batch_graph_arrays(arrays: Sequence[GraphArrays], *,
                       v_max: Optional[int] = None,
                       e_max: Optional[int] = None) -> GraphArraysBatch:
    """Pad and stack per-graph arrays for the vmapped multi-graph policy.

    ``v_max``/``e_max`` pin the node/edge axes beyond the batch maximum —
    the bucketed trainer fixes them per size bucket so every episode's
    subsample traces to the same jit shapes.
    """
    if not arrays:
        raise ValueError("batch_graph_arrays needs at least one graph")
    widths = {a.x.shape[1] for a in arrays}
    if len(widths) != 1:
        raise ValueError(
            f"feature widths differ across graphs ({sorted(widths)}); "
            "extract all graphs with one shared_feature_config()")
    vm = max(a.num_nodes for a in arrays)
    if v_max is not None:
        if v_max < vm:
            raise ValueError(f"v_max={v_max} < largest graph ({vm} nodes)")
        vm = v_max
    em = max(1, max(a.edges.shape[0] for a in arrays))
    if e_max is not None:
        if e_max < em:
            raise ValueError(f"e_max={e_max} < largest edge count ({em})")
        em = max(1, e_max)
    G, d = len(arrays), arrays[0].x.shape[1]
    x = np.zeros((G, vm, d), np.float32)
    adj = np.zeros((G, vm, vm), np.float32)
    edges = np.zeros((G, em, 2), np.int32)
    node_mask = np.zeros((G, vm), bool)
    edge_mask = np.zeros((G, em), bool)
    for i, a in enumerate(arrays):
        n, e = a.num_nodes, a.edges.shape[0]
        x[i, :n] = a.x
        adj[i, :n, :n] = a.adj
        edges[i, :e] = a.edges
        node_mask[i, :n] = True
        edge_mask[i, :e] = True
    return GraphArraysBatch(
        x=x, adj=adj, edges=edges, node_mask=node_mask, edge_mask=edge_mask,
        num_nodes=np.asarray([a.num_nodes for a in arrays], np.int32),
        num_edges=np.asarray([a.edges.shape[0] for a in arrays], np.int32))


def batch_graph_arrays_bucketed(arrays: Sequence[GraphArrays], *,
                                max_buckets: int,
                                buckets: Optional[Sequence[Sequence[int]]]
                                = None):
    """→ (buckets, batches): encoder-side twin of
    :func:`~repro_torch.core.costmodel.sim_arrays_bucketed` — the per-graph
    arrays split into ≤ ``max_buckets`` size-contiguous batches, each padded
    only to its own bucket maximum.
    """
    from .costmodel import plan_buckets
    if buckets is None:
        buckets = plan_buckets([a.num_nodes for a in arrays], max_buckets)
    batches = [batch_graph_arrays([arrays[i] for i in idx])
               for idx in buckets]
    return [list(idx) for idx in buckets], batches


def check_feature_compat(cfg: FeatureConfig,
                         graphs: Sequence[CompGraph]) -> None:
    """Validate that ``cfg``'s saved vocabularies cover ``graphs``.

    A warm-started policy is only meaningful if the new graphs' one-hot
    columns line up with the layout it was trained on; an op type absent
    from the saved ``op_vocab`` would be encoded all-zero.  Raises
    ``ValueError`` naming every mismatched op type.
    """
    if cfg.op_vocab is None:
        raise ValueError(
            "feature config has no op_vocab — it was not saved from a "
            "(shared-vocabulary) training run and cannot be validated "
            "against new graphs")
    known = set(cfg.op_vocab)
    missing: Dict[str, List[str]] = {}
    for g in graphs:
        unknown = sorted(set(g.op_types()) - known)
        if unknown:
            missing[g.name] = unknown
    if missing:
        detail = "; ".join(f"{name}: {ops}" for name, ops in
                           sorted(missing.items()))
        raise ValueError(
            f"checkpoint feature vocabulary does not cover the new graphs — "
            f"op types absent from the saved op_vocab would get all-zero "
            f"one-hot columns and silently corrupt fine-tuning. Unknown op "
            f"types by graph: {detail}. Re-train with a corpus spanning "
            f"these op types, or extract features with a fresh "
            f"shared_feature_config() and train from scratch.")


def extract_features(g: CompGraph,
                     cfg: FeatureConfig = FeatureConfig()) -> GraphArrays:
    """Assemble X^(0) per §2.3 and the dense graph view."""
    op_vocab = cfg.op_vocab or tuple(sorted(set(g.op_types())))
    in_deg = g.in_degrees()
    out_deg = g.out_degrees()
    in_vocab = cfg.in_deg_vocab or tuple(sorted(set(in_deg.tolist())))
    out_vocab = cfg.out_deg_vocab or tuple(sorted(set(out_deg.tolist())))

    order = topological_order(g)
    pos = np.empty(g.num_nodes, dtype=np.int64)
    pos[order] = np.arange(g.num_nodes)

    blocks: List[np.ndarray] = []
    slices: Dict[str, slice] = {}

    def push(name: str, arr: np.ndarray) -> None:
        start = sum(b.shape[1] for b in blocks)
        blocks.append(arr.astype(np.float32))
        slices[name] = slice(start, start + arr.shape[1])

    push("op_type", one_hot(g.op_types(), op_vocab))
    if cfg.use_output_shape:
        push("output_shape",
             _shape_features(g.output_shapes(), cfg.max_shape_rank,
                             cfg.log_shape))
    if cfg.use_structural:
        push("in_degree", one_hot(in_deg.tolist(), in_vocab))
        push("out_degree", one_hot(out_deg.tolist(), out_vocab))
        push("fractal", fractal_dimension(g)[:, None])
    if cfg.use_node_id:
        push("pos_enc", positional_encoding(pos, cfg.d_pos))

    x = np.concatenate(blocks, axis=1) if blocks else np.zeros((g.num_nodes, 0),
                                                               np.float32)
    type_lookup = {t: i for i, t in enumerate(op_vocab)}
    op_ids = np.asarray([type_lookup.get(t, 0) for t in g.op_types()],
                        dtype=np.int32)
    return GraphArrays(
        x=x,
        adj=g.adjacency(),
        edges=g.edges,
        topo_pos=pos.astype(np.int32),
        flops=g.flops(),
        bytes_out=g.bytes_out(),
        op_type_ids=op_ids,
        feature_slices=slices,
    )
