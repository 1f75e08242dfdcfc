"""Port parity, the workload corpus: each provider's graphs bitwise the
reference's (benchmark, synthetic, ``lm`` for each kind), the corpus
fingerprint of Table 8's corpus (less ``traced``) eager and streaming, the
spec parser's errors, the stream markers, the streaming LRU and its
nondeterministic-thunk check, ``GraphMeta`` against
``shared_feature_config``, the ``traced`` graphs against the reference's
jaxpr trace, Table 8's full corpus, ``lm:archs=all`` and ``layer_graph``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get as ref_arch  # noqa: E402
from repro.core import costmodel as refcm  # noqa: E402
from repro.core import features as reffeat  # noqa: E402
from repro.core.planner import layer_graph as ref_layer_graph  # noqa: E402
from repro.graphs import workloads as refwl  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.core import FeatureConfig, plan_buckets  # noqa: E402
from repro_torch.core import features as feat  # noqa: E402
from repro_torch.core.planner import layer_graph  # noqa: E402
from repro_torch.graphs import workloads as wl  # noqa: E402

#: Table 8's corpus (benchmarks/table8_corpus.py) without its traced entry
TABLE8 = ("benchmark:names=inception_v3+resnet50;"
          "lm:archs=qwen1.5-0.5b+mamba2-130m:seq_len=1024;"
          "synthetic:family=layered+series_parallel:count=6:size=40:seed=0")
TABLE8_FINGERPRINT = ("0bd992a6aa5692cdf61d67480cc504ab"
                      "5b591f4007af0a2afcf35c024d97ed3f")
TABLE8_BUCKETS = [[6, 3, 4, 9, 8, 2, 5, 7], [1], [0]]
#: Table 8's full corpus, its traced entry included
TABLE8_FULL = ("benchmark:names=inception_v3+resnet50;"
               "traced:archs=qwen1.5-0.5b+phi3-mini-3.8b;"
               "lm:archs=qwen1.5-0.5b+mamba2-130m:seq_len=1024;"
               "synthetic:family=layered+series_parallel:count=6:size=40:"
               "seed=0")
TABLE8_FULL_FINGERPRINT = ("9e4ccd26d9574549f9eec9ceb2505e56"
                           "2d16d0d59993868095c719bcd6b1f2d7")
TABLE8_FULL_BUCKETS = [[8, 5, 6, 11, 10, 2, 3, 4, 7, 9], [1], [0]]


def _assert_graphs_equal(mine, ref):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.name == b.name
        np.testing.assert_array_equal(a.edges, b.edges, err_msg=a.name)
        assert [dataclasses.astuple(n) for n in a.nodes] == \
            [dataclasses.astuple(n) for n in b.nodes], a.name


@pytest.mark.parametrize("spec", [
    "benchmark:names=resnet50",
    "synthetic:family=mixed:count=7:size=30:seed=3",
    "synthetic:family=branch_join:count=2:size=40:seed=123",
    "lm:archs=qwen1.5-0.5b+mamba2-130m:kinds=train+prefill+decode"
    ":seq_len=1024:batch=4",
    "synthetic:count=2:size=9;synthetic:count=2:size=9",
])
def test_providers_build_the_references_graphs(spec):
    """Each provider, and name uniquification across entries, bitwise."""
    mine, ref = wl.build_corpus(spec), refwl.build_corpus(spec)
    _assert_graphs_equal(mine, ref)
    assert wl.corpus_fingerprint(mine) == refwl.corpus_fingerprint(ref)


def test_the_table8_corpus_matches_the_reference():
    """Table 8's corpus: the graphs, their buckets and the fingerprint,
    eager and streaming, are the reference's."""
    eager = wl.build_corpus(TABLE8)
    ref = refwl.build_corpus(TABLE8)
    _assert_graphs_equal(eager, ref)
    sizes = [g.num_nodes for g in eager]
    assert plan_buckets(sizes, 3) == refcm.plan_buckets(sizes, 3) \
        == TABLE8_BUCKETS
    assert wl.corpus_fingerprint(eager) == refwl.corpus_fingerprint(ref) \
        == TABLE8_FINGERPRINT
    stream = wl.build_corpus("stream:" + TABLE8, cache_graphs=2)
    assert wl.corpus_fingerprint(stream) == TABLE8_FINGERPRINT
    assert [m.name for m in stream.meta] == [g.name for g in ref]
    for m, g in zip(stream.meta, ref):
        assert m == wl.GraphMeta.from_graph(g)


def test_graph_meta_drives_feature_config_and_buckets_as_the_graphs():
    spec = "synthetic:family=mixed:count=6:size=15:seed=2"
    graphs = wl.build_corpus(spec)
    meta = wl.StreamingCorpus(spec).meta
    base = FeatureConfig(d_pos=8)
    fc = feat.shared_feature_config(meta, base)
    assert fc == feat.shared_feature_config(graphs, base)
    ref_fc = reffeat.shared_feature_config(
        refwl.StreamingCorpus(spec).meta, reffeat.FeatureConfig(d_pos=8))
    assert dataclasses.asdict(fc) == dataclasses.asdict(ref_fc)
    feat.check_feature_compat(fc, meta)
    assert [m.num_nodes for m in meta] == [g.num_nodes for g in graphs]
    assert [m.max_in_degree for m in meta] == \
        [int(g.in_degrees().max()) for g in graphs]
    np.testing.assert_array_equal(meta[0].out_degrees(),
                                  graphs[0].out_degrees())


def test_streaming_corpus_lru_and_rebuilds():
    spec = "stream:synthetic:family=layered:count=5:size=12:seed=1"
    corpus = wl.build_corpus(spec, cache_graphs=2)
    eager = wl.build_corpus(spec[len("stream:"):])
    assert isinstance(corpus, wl.StreamingCorpus) and len(corpus) == 5
    assert corpus.cached_indices() == []
    g0 = corpus[0]
    assert corpus[0] is g0 and corpus[-5] is g0
    corpus[1]
    corpus[2]
    assert corpus.cached_indices() == [1, 2]
    g0b = corpus[0]                   # evicted: rebuilt, a fresh object
    assert g0b is not g0
    _assert_graphs_equal([g0b], [eager[0]])
    _assert_graphs_equal(list(corpus), eager)
    assert len(corpus.cached_indices()) == 2
    with pytest.raises(IndexError):
        corpus[5]
    with pytest.raises(ValueError, match="cache_graphs"):
        wl.StreamingCorpus(spec, cache_graphs=0)


def test_streaming_corpus_rejects_a_nondeterministic_provider():
    calls = []

    class Drifting(wl.WorkloadProvider):
        name = "test_drifting"

        def lazy_build(self, **params):
            def thunk():
                calls.append(1)
                return wl.SyntheticWorkloads._build_one(
                    ["layered"], 10 + 5 * len(calls), 0, 0)
            return [thunk]

    wl.register_workload(Drifting())
    corpus = wl.StreamingCorpus("test_drifting", cache_graphs=1)
    with pytest.raises(RuntimeError, match="nondeterministic"):
        corpus[0]


def test_spec_parser_and_its_errors():
    spec = wl.parse_corpus_spec(
        " benchmark:names=bert_base ; synthetic:family=layered+branch_join"
        ":count=3 ;")
    ref = refwl.parse_corpus_spec(
        " benchmark:names=bert_base ; synthetic:family=layered+branch_join"
        ":count=3 ;")
    assert spec.entries == ref.entries and spec.mode is None
    assert str(spec) == str(ref)
    for bad, match in (("", "empty corpus spec"),
                       ("bogus:count=3", "segment 0.*unknown workload"),
                       ("synthetic;benchmark:names", "segment 1.*malformed"),
                       ("synthetic:=3", "empty key"),
                       ("stream:synthetic;eager:benchmark",
                        "segment 1.*contradicts")):
        with pytest.raises(ValueError, match=match):
            wl.parse_corpus_spec(bad)
        with pytest.raises(ValueError, match=match):
            refwl.parse_corpus_spec(bad)
    for marked in ("stream:synthetic:count=2", "stream;synthetic:count=2"):
        assert wl.parse_corpus_spec(marked).mode == "stream"
        assert str(wl.parse_corpus_spec(marked)) == \
            str(refwl.parse_corpus_spec(marked))
    assert isinstance(wl.build_corpus("eager:synthetic:count=2"), list)
    assert isinstance(wl.build_corpus("synthetic:count=2", stream=True),
                      wl.StreamingCorpus)
    for spec, stream in (("stream:synthetic:count=2", False),
                         ("eager:synthetic:count=2", True)):
        with pytest.raises(ValueError, match="contradicts"):
            wl.build_corpus(spec, stream=stream)
    with pytest.raises(ValueError, match="unknown parameters"):
        wl.build_corpus("synthetic:bogus=1")
    with pytest.raises(ValueError, match="unknown benchmark"):
        wl.build_corpus("benchmark:names=vgg")
    with pytest.raises(ValueError, match="unknown synthetic"):
        wl.build_corpus("synthetic:family=ring")


def test_registry_and_the_ports_missing_providers_raise():
    def builtin(names):
        return [n for n in names if not n.startswith("test_")]
    assert builtin(wl.workload_names()) == builtin(refwl.workload_names()) \
        == ["benchmark", "lm", "synthetic", "traced"]
    with pytest.raises(ValueError, match="unknown workload provider"):
        wl.get_workload("bogus")
    spec = wl.parse_corpus_spec("traced:archs=qwen1.5-0.5b")
    assert spec.entries == refwl.parse_corpus_spec(
        "traced:archs=qwen1.5-0.5b").entries
    _assert_graphs_equal(wl.build_corpus(spec), refwl.build_corpus(spec))
    # archs=all names the reference's ten archs in both packages: the
    # corpus, bit for bit, and its fingerprint, eager and streaming
    for spec in ("lm:archs=all", "traced:archs=all"):
        mine, ref = wl.build_corpus(spec), refwl.build_corpus(spec)
        assert len(mine) == 10
        _assert_graphs_equal(mine, ref)
        assert wl.corpus_fingerprint(mine) == refwl.corpus_fingerprint(ref)
    assert wl.StreamingCorpus("traced").fingerprint == \
        refwl.corpus_fingerprint(refwl.build_corpus("traced"))
    with pytest.raises(KeyError):
        wl.build_corpus("lm:archs=no-such-arch")

    class Neither(wl.WorkloadProvider):
        name = "test_neither"
    with pytest.raises(NotImplementedError, match="neither"):
        Neither().build()
    with pytest.raises(NotImplementedError, match="neither"):
        Neither().lazy_build()

    class BuildOnly(wl.WorkloadProvider):
        name = "test_build_only"

        def build(self, **params):
            return wl.get_workload("synthetic").build(count=2, size=8)
    thunks = BuildOnly().lazy_build()
    _assert_graphs_equal([t() for t in thunks], BuildOnly().build())


@pytest.mark.parametrize("arch", [
    "qwen1.5-0.5b", "mamba2-130m", "h2o-danube-1.8b", "phi3-mini-3.8b",
    "olmoe-1b-7b", "mixtral-8x22b", "jamba-1.5-large-398b",
    "command-r-plus-104b", "internvl2-76b", "musicgen-medium"])
def test_layer_graph_matches_the_reference(arch):
    for kind in ("train", "prefill", "decode"):
        for cfg, ref_cfg in ((get(arch).config, ref_arch(arch).config),
                             (get(arch).smoke_config,
                              ref_arch(arch).smoke_config)):
            _assert_graphs_equal([layer_graph(cfg, 512, 3, kind)],
                                 [ref_layer_graph(ref_cfg, 512, 3, kind)])
    # an MoE pattern on a dense arch's config: its router and top-k experts
    # priced as the reference prices them
    change = dict(block_pattern=(("attn", "moe"),), moe_experts=4,
                  moe_top_k=2)
    moe = dataclasses.replace(get(arch).smoke_config, **change)
    ref_moe = dataclasses.replace(ref_arch(arch).smoke_config, **change)
    _assert_graphs_equal([layer_graph(moe, 64, 1)],
                         [ref_layer_graph(ref_moe, 64, 1)])


@pytest.mark.parametrize("seq", [32, 64])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "phi3-mini-3.8b"])
def test_traced_graphs_match_the_references_jaxpr_trace(arch, seq):
    """The numpy layer graph bitwise the reference's ``trace_to_graph``:
    names, op types, shapes, FLOPs, bytes and edges (a JAX release that
    traces the layer otherwise fails here)."""
    spec = f"traced:archs={arch}:seq_len={seq}"
    mine, ref = wl.build_corpus(spec), refwl.build_corpus(spec)
    _assert_graphs_equal(mine, ref)
    g = mine[0]
    assert (g.num_nodes, g.num_edges, len(set(g.op_types()))) == \
        (40, 47, 16)


def test_the_full_table8_corpus_matches_the_reference():
    """Table 8's full corpus, ``traced`` included: graphs, buckets and the
    fingerprint the reference's, eager and streaming."""
    eager = wl.build_corpus(TABLE8_FULL)
    ref = refwl.build_corpus(TABLE8_FULL)
    _assert_graphs_equal(eager, ref)
    sizes = [g.num_nodes for g in eager]
    assert sizes == [602, 341, 40, 40, 50, 26, 35, 56, 17, 56, 38, 36]
    assert plan_buckets(sizes, 3) == refcm.plan_buckets(sizes, 3) \
        == TABLE8_FULL_BUCKETS
    assert wl.corpus_fingerprint(eager) == refwl.corpus_fingerprint(ref) \
        == TABLE8_FULL_FINGERPRINT
    stream = wl.build_corpus("stream:" + TABLE8_FULL, cache_graphs=2)
    assert wl.corpus_fingerprint(stream) == TABLE8_FULL_FINGERPRINT
