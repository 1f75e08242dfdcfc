"""Workload-corpus subsystem: pluggable graph sources behind one registry.

Port of ``repro/graphs/workloads.py``.  A :class:`WorkloadProvider` turns a
parameter dict into a list of :class:`~repro_torch.core.graph.CompGraph`;
providers register under a name; :func:`build_corpus` assembles a
heterogeneous corpus from a spec — either a :class:`CorpusSpec` or its
string form::

    benchmark                                    # the three Table-2 graphs
    benchmark:names=bert_base                    # a subset
    lm:archs=qwen1.5-0.5b+mamba2-130m            # layer graphs from configs/
    synthetic:family=layered:count=4:size=40     # seedable DAG families

Entries are ``;``-separated, provider parameters ``:``-separated
``key=value`` pairs (``+`` separates list values)::

    build_corpus("benchmark;synthetic:family=mixed:count=9:size=30:seed=0")

Every provider builds the reference's graphs bit for bit (the builders are
numpy copies), so :func:`corpus_fingerprint` — a content hash of topology,
costs and op types that checkpoint manifests record — is the reference's
for the same spec, and a corpus checkpoint of either package resumes in
the other.

The reference's ``traced`` provider (``trace_to_graph`` of a transformer
layer written in ``jax.numpy``) builds the same graphs here from a numpy
description of the layer's jaxpr (``graphs/traced.py``).  ``lm`` and
``traced`` build the reference's ten archs; ``archs=all`` names them all,
in the registry's sorted order, as the reference's does.

Streaming corpora
-----------------

Providers expose :meth:`WorkloadProvider.lazy_build` — per-graph *thunks*
instead of materialized graphs — and :class:`StreamingCorpus` wraps a spec
as a sequence that builds graphs on demand behind an LRU (``cache_graphs``
dense graphs resident at once).  A one-pass init sweep materializes each
graph transiently to record its :class:`GraphMeta` and the fingerprint
:func:`corpus_fingerprint` computes for the eager list, so streaming and
eager runs of one spec are interchangeable in checkpoints.

Spec strings opt in with a ``stream:`` head marker (``eager:`` pins the
default): ``stream:synthetic:count=1000:size=150``.  Mixing both markers in
one spec is a hard error naming the offending segment.

Registering a provider::

    class MyWorkloads(WorkloadProvider):
        name = "mine"
        def lazy_build(self, **params): return [thunk, ...]   # or build()
    register_workload(MyWorkloads())
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple, Union

import numpy as np

from ..core.graph import CompGraph
from .bert import bert_base
from .inception import inception_v3
from .resnet import resnet50
from .synthetic import SYNTHETIC_FAMILIES

__all__ = [
    "WorkloadProvider", "register_workload", "get_workload",
    "workload_names", "CorpusSpec", "parse_corpus_spec", "build_corpus",
    "corpus_fingerprint", "GraphMeta", "StreamingCorpus",
]

GraphThunk = Callable[[], CompGraph]

class WorkloadProvider:
    """Interface every graph source implements (see module docstring).

    Implement **one** of :meth:`build` / :meth:`lazy_build`; each default
    delegates to the other.  ``lazy_build`` is the preferred hook — it
    yields per-graph thunks so :class:`StreamingCorpus` never holds the
    whole entry dense; a provider that only implements ``build`` still
    streams, but each thunk re-materializes the full entry to pick one
    graph out of it.
    """

    name: str = "?"

    def build(self, **params) -> List[CompGraph]:
        """Materialize this provider's graphs for one spec entry."""
        if type(self).lazy_build is WorkloadProvider.lazy_build:
            raise NotImplementedError(
                f"workload provider {self.name!r} implements neither "
                f"build() nor lazy_build()")
        return [thunk() for thunk in self.lazy_build(**params)]

    def lazy_build(self, **params) -> List[GraphThunk]:
        """Per-graph thunks for one spec entry (see class docstring)."""
        if type(self).build is WorkloadProvider.build:
            raise NotImplementedError(
                f"workload provider {self.name!r} implements neither "
                f"build() nor lazy_build()")
        count = len(self.build(**params))
        return [(lambda i=i: self.build(**params)[i])
                for i in range(count)]


_REGISTRY: Dict[str, WorkloadProvider] = {}


def register_workload(provider: WorkloadProvider) -> WorkloadProvider:
    """Register ``provider`` under ``provider.name`` (latest wins)."""
    _REGISTRY[provider.name] = provider
    return provider


def get_workload(name: str) -> WorkloadProvider:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown workload provider {name!r}; registered providers: "
            f"{workload_names()}")
    return _REGISTRY[name]


def workload_names() -> List[str]:
    return sorted(_REGISTRY)


# --------------------------------------------------------------- providers
class BenchmarkWorkloads(WorkloadProvider):
    """The paper's Table-2 graphs (``names=`` subset, default all three)."""

    name = "benchmark"
    _BUILDERS = {"inception_v3": inception_v3, "resnet50": resnet50,
                 "bert_base": bert_base}

    def lazy_build(self, names: Union[str, Sequence[str]] = "all",
                   **params) -> List[GraphThunk]:
        _reject_unknown(self.name, params)
        if names == "all":
            names = sorted(self._BUILDERS)
        elif isinstance(names, str):
            names = [names]
        unknown = [n for n in names if n not in self._BUILDERS]
        if unknown:
            raise ValueError(f"unknown benchmark graphs {unknown}; "
                             f"available: {sorted(self._BUILDERS)}")
        return [self._BUILDERS[n] for n in names]


class LMLayerWorkloads(WorkloadProvider):
    """Layer-granularity LM graphs from the ``configs/`` model registry.

    One graph per (arch, kind): the analytic layer graph
    (``core.planner.layer_graph``) of the registered architecture, whose
    flops/bytes come from the real ModelConfig.
    """

    name = "lm"

    def lazy_build(self, archs: Union[str, Sequence[str]] = "all",
                   kinds: Union[str, Sequence[str]] = "train",
                   seq_len: int = 4096, batch: int = 8,
                   **params) -> List[GraphThunk]:
        _reject_unknown(self.name, params)
        from ..configs import all_archs, get
        from ..core.planner import layer_graph
        if archs == "all":
            archs = list(all_archs())
        elif isinstance(archs, str):
            archs = [archs]
        if isinstance(kinds, str):
            kinds = [kinds]
        return [
            (lambda a=a, kind=kind: layer_graph(
                get(a).config, int(seq_len), int(batch), kind))
            for a in archs for kind in kinds]


class TracedLayerWorkloads(WorkloadProvider):
    """The reference's ``trace_to_graph``-derived transformer-layer graphs.

    One attention + FFN layer at each named arch's *smoke* dimensions, with
    jaxpr-primitive op types (``dot_general``, ``exp``, ``reduce_sum``,
    ...) rather than the OpenVINO-style builders'.  The reference traces the
    layer with JAX; the port builds the same graph in numpy
    (:func:`~repro_torch.graphs.traced.traced_layer_graph`).
    """

    name = "traced"

    def lazy_build(self, archs: Union[str, Sequence[str]] = "all",
                   seq_len: int = 32, **params) -> List[GraphThunk]:
        _reject_unknown(self.name, params)
        from ..configs import all_archs, get
        from .traced import traced_layer_graph
        if archs == "all":
            archs = list(all_archs())
        elif isinstance(archs, str):
            archs = [archs]

        def build(a: str) -> CompGraph:
            cfg = get(a).smoke_config
            return traced_layer_graph(
                int(seq_len), cfg.d_model, max(1, cfg.n_heads),
                cfg.head_dim_, cfg.d_ff, name=f"{cfg.name}/traced_layer")

        return [(lambda a=a: build(a)) for a in archs]


class SyntheticWorkloads(WorkloadProvider):
    """Seedable synthetic families (``graphs/synthetic.py``).

    ``family`` — ``layered`` | ``series_parallel`` | ``branch_join`` |
    ``mixed`` (cycles all three); ``count`` graphs of roughly ``size`` nodes
    (jittered ±50% per graph so a corpus spans sizes), seeded from ``seed``.
    """

    name = "synthetic"

    def lazy_build(self, family: Union[str, Sequence[str]] = "mixed",
                   count: int = 4, size: int = 32,
                   seed: int = 0, **params) -> List[GraphThunk]:
        _reject_unknown(self.name, params)
        count, size, seed = int(count), int(size), int(seed)
        if family == "mixed":
            fams = sorted(SYNTHETIC_FAMILIES)
        else:
            fams = [family] if isinstance(family, str) else list(family)
            unknown = [f for f in fams if f not in SYNTHETIC_FAMILIES]
            if unknown:
                raise ValueError(
                    f"unknown synthetic families {unknown}; available: "
                    f"{sorted(SYNTHETIC_FAMILIES)} or 'mixed'")
        return [(lambda i=i: self._build_one(fams, size, seed, i))
                for i in range(count)]

    @staticmethod
    def _build_one(fams: Sequence[str], size: int, seed: int,
                   i: int) -> CompGraph:
        """Graph ``i`` of the entry — per-index seeding, so any single
        graph rebuilds identically without touching its neighbours."""
        fam = fams[i % len(fams)]
        rng = np.random.default_rng((seed, i))
        n = max(4, int(size * float(rng.uniform(0.5, 1.5))))
        gseed = int(rng.integers(0, 2**31))
        if fam == "layered":
            width = max(1, int(rng.integers(2, 6)))
            g = SYNTHETIC_FAMILIES[fam](
                num_layers=max(1, n // (width + 1)), width=width,
                seed=gseed)
        elif fam == "series_parallel":
            g = SYNTHETIC_FAMILIES[fam](target_nodes=n, seed=gseed)
        else:
            branches = max(2, int(rng.integers(2, 6)))
            depth = max(1, int(rng.integers(1, 4)))
            g = SYNTHETIC_FAMILIES[fam](
                num_blocks=max(1, n // (branches * depth + 1)),
                branches=branches, depth=depth, seed=gseed)
        g.name = f"{g.name}#{i}"
        return g


def _reject_unknown(provider: str, params: Dict) -> None:
    if params:
        raise ValueError(f"workload provider {provider!r} got unknown "
                         f"parameters {sorted(params)}")


register_workload(BenchmarkWorkloads())
register_workload(LMLayerWorkloads())
register_workload(TracedLayerWorkloads())
register_workload(SyntheticWorkloads())


# ------------------------------------------------------------- corpus spec
_MODE_MARKERS = ("stream", "eager")


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    """An ordered list of (provider name, params) entries.

    ``mode`` records a ``stream:`` / ``eager:`` head marker from the string
    form (``None`` = unmarked; :func:`build_corpus` then defaults to eager
    unless its ``stream=`` argument says otherwise).
    """

    entries: Tuple[Tuple[str, Tuple[Tuple[str, object], ...]], ...]
    mode: Optional[str] = None

    def __str__(self) -> str:
        parts = []
        for name, params in self.entries:
            toks = [name] + [
                f"{k}={'+'.join(map(str, v)) if isinstance(v, (list, tuple)) else v}"
                for k, v in params]
            parts.append(":".join(toks))
        out = ";".join(parts)
        return f"{self.mode}:{out}" if self.mode else out


def parse_corpus_spec(spec: str) -> CorpusSpec:
    """Parse the ``provider:key=val:key=val;provider:...`` string form.

    A segment may lead with a ``stream`` or ``eager`` mode marker — as a
    prefix (``stream:synthetic:count=1000``) or a bare segment
    (``stream;synthetic:...``).  The marker sets :attr:`CorpusSpec.mode`;
    mixing both markers in one spec is contradictory and rejected.

    Malformed segments fail loudly: an unknown provider, a bad
    ``key=value`` token or a contradictory mode marker raises
    ``ValueError`` naming the offending segment and its position in the
    spec.
    """
    entries = []
    mode: Optional[str] = None
    for pos, part in enumerate(str(spec).split(";")):
        part = part.strip()
        if not part:
            continue
        toks = part.split(":")
        head = toks[0].strip()
        if head in _MODE_MARKERS:
            if mode is not None and mode != head:
                raise ValueError(
                    f"corpus spec segment {pos} ({part!r}): mode marker "
                    f"{head!r} contradicts earlier {mode!r} — a spec is "
                    f"all-streaming or all-eager, pick one")
            mode = head
            toks = toks[1:]
            if not toks:
                continue                     # bare marker segment
        name = toks[0].strip()
        try:
            get_workload(name)       # fail fast on unknown providers
        except ValueError as e:
            raise ValueError(
                f"corpus spec segment {pos} ({part!r}): {e}") from None
        params = []
        for tok in toks[1:]:
            if "=" not in tok:
                raise ValueError(
                    f"corpus spec segment {pos} ({part!r}): malformed "
                    f"token {tok!r} (expected key=value)")
            k, v = tok.split("=", 1)
            k = k.strip()
            if not k:
                raise ValueError(
                    f"corpus spec segment {pos} ({part!r}): malformed "
                    f"token {tok!r} (empty key)")
            vv: object = [s for s in v.split("+")] if "+" in v else v
            params.append((k, vv))
        entries.append((name, tuple(params)))
    if not entries:
        raise ValueError(f"empty corpus spec {spec!r}")
    return CorpusSpec(tuple(entries), mode=mode)


# --------------------------------------------------------------- streaming
@dataclasses.dataclass(frozen=True)
class GraphMeta:
    """Static per-graph facts a trainer needs *without* the graph.

    Duck-types the :class:`CompGraph` accessors that feature-config
    building (``shared_feature_config`` / ``check_feature_compat``) and
    bucket planning consume — name, sizes and the op/degree vocabularies —
    so a streaming corpus can plan everything up front and materialize
    dense graphs only when an episode samples them.
    """

    name: str
    num_nodes: int
    num_edges: int
    max_in_degree: int
    op_type_seq: Tuple[str, ...]
    in_degree_seq: Tuple[int, ...]
    out_degree_seq: Tuple[int, ...]

    @classmethod
    def from_graph(cls, g: CompGraph) -> "GraphMeta":
        in_deg = g.in_degrees()
        return cls(
            name=g.name,
            num_nodes=int(g.num_nodes),
            num_edges=int(g.edges.shape[0]),
            max_in_degree=int(in_deg.max()) if in_deg.size else 0,
            op_type_seq=tuple(g.op_types()),
            in_degree_seq=tuple(int(d) for d in in_deg),
            out_degree_seq=tuple(int(d) for d in g.out_degrees()))

    # CompGraph-compatible accessors (vocab duck-typing)
    def op_types(self) -> List[str]:
        return list(self.op_type_seq)

    def in_degrees(self) -> np.ndarray:
        return np.asarray(self.in_degree_seq, dtype=np.int64)

    def out_degrees(self) -> np.ndarray:
        return np.asarray(self.out_degree_seq, dtype=np.int64)


class StreamingCorpus:
    """A corpus spec as a lazy graph sequence behind a per-graph LRU.

    ``__init__`` walks every provider thunk once, materializing each graph
    *transiently* (one at a time) to apply :func:`build_corpus`'s name
    uniquification, record :class:`GraphMeta` and accumulate the exact
    :func:`corpus_fingerprint` hash — then drops it.  ``corpus[i]``
    re-materializes on demand; at most ``cache_graphs`` dense graphs stay
    resident, least-recently-used evicted first.  Rebuilt graphs are
    fresh objects, so anything keyed on graph *identity* (the SimArrays
    weak cache in ``core.costmodel``) releases with the eviction.
    """

    def __init__(self, spec: Union[str, CorpusSpec], *,
                 cache_graphs: int = 16):
        if isinstance(spec, str):
            spec = parse_corpus_spec(spec)
        if int(cache_graphs) < 1:
            raise ValueError(
                f"cache_graphs must be >= 1, got {cache_graphs}")
        self.spec = spec
        self.cache_graphs = int(cache_graphs)
        thunks: List[GraphThunk] = []
        for name, params in spec.entries:
            thunks.extend(get_workload(name).lazy_build(**dict(params)))
        names: List[str] = []
        metas: List[GraphMeta] = []
        seen: Dict[str, int] = {}
        h = hashlib.sha256()
        for thunk in thunks:
            g = thunk()
            n = seen.get(g.name, 0) + 1
            seen[g.name] = n
            if n > 1:
                g.name = f"{g.name}/{n}"
            names.append(g.name)
            _fingerprint_one(h, g)
            metas.append(GraphMeta.from_graph(g))
        self._thunks = thunks
        self._names = names
        self.meta: Tuple[GraphMeta, ...] = tuple(metas)
        self._fingerprint = h.hexdigest()
        self._lru: "collections.OrderedDict[int, CompGraph]" = \
            collections.OrderedDict()

    @property
    def fingerprint(self) -> str:
        """Equal to ``corpus_fingerprint(build_corpus(spec))`` by construction."""
        return self._fingerprint

    def __len__(self) -> int:
        return len(self._thunks)

    def __getitem__(self, i: int) -> CompGraph:
        i = int(i)
        if i < 0:
            i += len(self._thunks)
        if not 0 <= i < len(self._thunks):
            raise IndexError(f"graph index {i} out of range "
                             f"[0, {len(self._thunks)})")
        g = self._lru.get(i)
        if g is not None:
            self._lru.move_to_end(i)
            return g
        g = self._thunks[i]()
        g.name = self._names[i]      # re-apply corpus-level uniquification
        # A provider thunk must re-materialize the *same* graph the init
        # sweep recorded; sizes are the cheap invariant every downstream
        # consumer (bucket plan, SimArrays, features) keys on, so check
        # them on every rebuild.
        meta = self.meta[i]
        nn, ne = int(g.num_nodes), int(g.edges.shape[0])
        if nn != meta.num_nodes or ne != meta.num_edges:
            raise RuntimeError(
                f"streaming corpus graph {meta.name!r} (index {i}) "
                f"re-materialized with {nn} nodes / {ne} edges but was "
                f"recorded at init with {meta.num_nodes} nodes / "
                f"{meta.num_edges} edges — the provider thunk is "
                f"nondeterministic; seed it or materialize eagerly")
        self._lru[i] = g
        while len(self._lru) > self.cache_graphs:
            self._lru.popitem(last=False)
        return g

    def __iter__(self) -> Iterator[CompGraph]:
        return (self[i] for i in range(len(self)))

    def cached_indices(self) -> List[int]:
        """Currently resident graph indices, LRU-first (for tests/metrics)."""
        return list(self._lru)


def build_corpus(spec: Union[str, CorpusSpec], *,
                 stream: Optional[bool] = None,
                 cache_graphs: int = 16
                 ) -> Union[List[CompGraph], StreamingCorpus]:
    """Materialize every entry of ``spec`` into one graph list.

    Graph names are uniquified (``/2``, ``/3`` suffixes) so per-graph
    reporting stays unambiguous when entries overlap.

    ``stream=True`` (or a ``stream:`` spec marker) returns a
    :class:`StreamingCorpus` instead of a dense list; an explicit
    ``stream`` argument that contradicts the spec's own marker is an
    error.
    """
    if isinstance(spec, str):
        spec = parse_corpus_spec(spec)
    if stream is not None and spec.mode is not None \
            and bool(stream) != (spec.mode == "stream"):
        raise ValueError(
            f"stream={stream!r} contradicts the corpus spec's "
            f"{spec.mode!r} marker ({str(spec)!r}) — drop one of them")
    streaming = bool(stream) if stream is not None \
        else spec.mode == "stream"
    if streaming:
        return StreamingCorpus(spec, cache_graphs=cache_graphs)
    graphs: List[CompGraph] = []
    seen: Dict[str, int] = {}
    for name, params in spec.entries:
        for g in get_workload(name).build(**dict(params)):
            n = seen.get(g.name, 0) + 1
            seen[g.name] = n
            if n > 1:
                g.name = f"{g.name}/{n}"
            graphs.append(g)
    return graphs


def _fingerprint_one(h, g: CompGraph) -> None:
    h.update(g.name.encode())
    h.update(np.int64(g.num_nodes).tobytes())
    h.update(np.ascontiguousarray(g.edges).tobytes())
    h.update(np.ascontiguousarray(g.flops()).tobytes())
    h.update(np.ascontiguousarray(g.bytes_out()).tobytes())
    h.update("|".join(g.op_types()).encode())


def corpus_fingerprint(
        graphs: Union[Sequence[CompGraph], StreamingCorpus]) -> str:
    """Order-sensitive content hash of a corpus (topology, costs, op types).

    Checkpoint manifests record it; resume refuses a mismatched corpus.  A
    :class:`StreamingCorpus` answers from its init-sweep hash — identical
    by construction — without materializing anything.
    """
    if isinstance(graphs, StreamingCorpus):
        return graphs.fingerprint
    h = hashlib.sha256()
    for g in graphs:
        _fingerprint_one(h, g)
    return h.hexdigest()
