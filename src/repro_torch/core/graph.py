"""Computation-graph IR (paper §2.1–2.2).

A :class:`CompGraph` is a labeled, unweighted, directed acyclic graph whose
nodes are operations (op type, output shape, FLOPs, bytes) and whose edges are
data dependencies.  It is the object every stage of HSDAG operates on: feature
extraction (§2.3), GPN parsing (§2.4), placement (§2.5) and the latency
backends all consume the dense array view produced by :meth:`CompGraph.arrays`.

Graphs here are *small* (paper Table 1: 396–1009 nodes) — the heavy numerics
live in PyTorch; graph topology bookkeeping stays in numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "OpNode",
    "CompGraph",
    "topological_order",
    "colocate_chains",
]


@dataclasses.dataclass
class OpNode:
    """One operation of a computation graph.

    ``flops``/``bytes_out`` feed the latency backends; ``output_shape`` feeds
    the §2.3 node-specific features.
    """

    name: str
    op_type: str
    output_shape: Tuple[int, ...] = ()
    flops: float = 0.0
    bytes_out: float = 0.0
    # Free-form metadata (e.g. layer index for LM layer graphs).
    meta: Optional[dict] = None

    @property
    def bytes_read(self) -> float:
        # Rough default: an op reads what its producers emit; builders may
        # override via meta["bytes_read"].
        if self.meta and "bytes_read" in self.meta:
            return float(self.meta["bytes_read"])
        return self.bytes_out


class CompGraph:
    """Directed acyclic computation graph with dense numpy views."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: List[OpNode] = []
        self._edges: List[Tuple[int, int]] = []
        self._index: Dict[str, int] = {}

    # ------------------------------------------------------------------ build
    def add_node(self, node: OpNode) -> int:
        if node.name in self._index:
            raise ValueError(f"duplicate node name {node.name!r}")
        idx = len(self.nodes)
        self.nodes.append(node)
        self._index[node.name] = idx
        return idx

    def add_op(self, name: str, op_type: str, inputs: Sequence[str] = (),
               output_shape: Tuple[int, ...] = (), flops: float = 0.0,
               bytes_out: float = 0.0, meta: Optional[dict] = None) -> int:
        idx = self.add_node(OpNode(name, op_type, tuple(output_shape),
                                   float(flops), float(bytes_out), meta))
        for src in inputs:
            self.add_edge(src, name)
        return idx

    def add_edge(self, src, dst) -> None:
        s = self._index[src] if isinstance(src, str) else int(src)
        d = self._index[dst] if isinstance(dst, str) else int(dst)
        if s == d:
            raise ValueError("self loop")
        self._edges.append((s, d))

    def index_of(self, name: str) -> int:
        return self._index[name]

    # ------------------------------------------------------------------ views
    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_edges(self) -> int:
        return len(self._edges)

    @property
    def edges(self) -> np.ndarray:
        """(E, 2) int array of (src, dst)."""
        if not self._edges:
            return np.zeros((0, 2), dtype=np.int32)
        return np.asarray(self._edges, dtype=np.int32)

    def adjacency(self) -> np.ndarray:
        """Binary asymmetric adjacency matrix A (Def. 2.1)."""
        n = self.num_nodes
        a = np.zeros((n, n), dtype=np.float32)
        e = self.edges
        if len(e):
            a[e[:, 0], e[:, 1]] = 1.0
        return a

    def in_degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, dtype=np.int64)
        for _, d in self._edges:
            deg[d] += 1
        return deg

    def out_degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, dtype=np.int64)
        for s, _ in self._edges:
            deg[s] += 1
        return deg

    def op_types(self) -> List[str]:
        return [n.op_type for n in self.nodes]

    def flops(self) -> np.ndarray:
        return np.asarray([n.flops for n in self.nodes], dtype=np.float64)

    def bytes_out(self) -> np.ndarray:
        return np.asarray([n.bytes_out for n in self.nodes], dtype=np.float64)

    def output_shapes(self) -> List[Tuple[int, ...]]:
        return [n.output_shape for n in self.nodes]

    def avg_degree(self) -> float:
        """|E| / |V| — the d̄ column of paper Table 1."""
        return self.num_edges / max(1, self.num_nodes)

    def validate_acyclic(self) -> None:
        topological_order(self)  # raises on cycle

    # ------------------------------------------------------------- transforms
    def subgraph_contraction(self, labels: np.ndarray,
                             name: Optional[str] = None) -> "CompGraph":
        """Contract nodes sharing a label into one node (used by Appendix-G
        co-location and by tests).  Aggregates flops/bytes; op type is the
        label-majority type (paper App. G uses the mean of types — with one-hot
        types the mean's argmax is the majority)."""
        labels = np.asarray(labels)
        uniq, inv = np.unique(labels, return_inverse=True)
        g = CompGraph(name or f"{self.name}/contracted")
        for ci, lab in enumerate(uniq):
            members = np.nonzero(inv == ci)[0]
            types = [self.nodes[m].op_type for m in members]
            vals, counts = np.unique(types, return_counts=True)
            maj = str(vals[np.argmax(counts)])
            shape = max((self.nodes[m].output_shape for m in members),
                        key=lambda s: int(np.prod(s)) if s else 0)
            g.add_node(OpNode(
                name=f"c{ci}", op_type=maj, output_shape=shape,
                flops=float(sum(self.nodes[m].flops for m in members)),
                bytes_out=float(sum(self.nodes[m].bytes_out for m in members)),
                meta={"members": members.tolist()}))
        seen = set()
        for s, d in self._edges:
            cs, cd = int(inv[s]), int(inv[d])
            if cs != cd and (cs, cd) not in seen:
                seen.add((cs, cd))
                g.add_edge(cs, cd)
        return g


def topological_order(g: CompGraph) -> np.ndarray:
    """Kahn topological order; deterministic (smallest index first).

    Feeds the positional features (§2.3): ``id(v_i)=i``.
    Raises ``ValueError`` on a cycle.
    """
    n = g.num_nodes
    indeg = g.in_degrees().copy()
    succ: List[List[int]] = [[] for _ in range(n)]
    for s, d in g.edges:
        succ[int(s)].append(int(d))
    import heapq

    ready = [i for i in range(n) if indeg[i] == 0]
    heapq.heapify(ready)
    order = np.empty(n, dtype=np.int64)
    k = 0
    while ready:
        v = heapq.heappop(ready)
        order[k] = v
        k += 1
        for w in succ[v]:
            indeg[w] -= 1
            if indeg[w] == 0:
                heapq.heappush(ready, w)
    if k != n:
        raise ValueError(f"graph {g.name!r} has a cycle")
    return order


def colocate_chains(g: CompGraph) -> Tuple[CompGraph, np.ndarray]:
    """Appendix-G co-location heuristic.

    Traversing nodes in topological order: if ``v_j`` is the sole child of
    ``v_i`` and ``v_i`` is the sole parent of ``v_j``, they join the same
    co-location set.  Returns the coarsened graph and the |V|-vector of
    co-location labels.
    """
    n = g.num_nodes
    out_deg = g.out_degrees()
    in_deg = g.in_degrees()
    succ: List[List[int]] = [[] for _ in range(n)]
    for s, d in g.edges:
        succ[int(s)].append(int(d))

    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for v in topological_order(g):
        v = int(v)
        if out_deg[v] == 1:
            j = succ[v][0]
            if in_deg[j] == 1:
                parent[find(j)] = find(v)

    labels = np.asarray([find(i) for i in range(n)])
    coarse = g.subgraph_contraction(labels, name=f"{g.name}/colocated")
    return coarse, labels
