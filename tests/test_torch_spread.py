"""The reference's search-quality record, ``tools/reference_search_spread.json``,
that ``chip_smoke.py`` holds the port's search against: three paper graphs ×
two engines × 12 seeds of finite best latencies, searched with the config
``chip_smoke.py`` searches the port with."""
import importlib.util
import json
import math
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_spread_has_every_graph_engine_and_seed():
    smoke = _chip_smoke()
    with open(smoke.SPREAD_JSON) as f:
        doc = json.load(f)
    assert doc["config"] == smoke.SPREAD_CONFIG
    assert doc["seeds"] == list(range(12))
    assert doc["platform"] == "paper_platform()"
    assert doc["jax_version"] and doc["date"]
    assert set(doc["results"]) == {"inception_v3", "resnet50", "bert_base"}
    for name, row in doc["results"].items():
        assert set(row) == {"auto", "level"}, name
        for engine, by_seed in row.items():
            assert set(by_seed) == {str(s) for s in doc["seeds"]}
            lat = list(by_seed.values())
            assert all(math.isfinite(x) and 0 < x < 1 for x in lat), (
                name, engine)


def test_reference_topology_spread_is_chip_smokes_table_13():
    """``tools/reference_topology_spread.json``: the device-head search's
    config and the fleets as ``chip_smoke.py`` searches them, finite best
    latencies of seeds 0-11 on the contract's fleets, host latencies within
    1e-5 of the scored ones, and a DP bound of every fleet that lies below
    every search."""
    smoke = _chip_smoke()
    with open(smoke.TOPO_JSON) as f:
        doc = json.load(f)
    assert doc["config"] == smoke.TOPO_CONFIG
    assert doc["seeds"] == list(range(12))
    assert doc["jax_version"] and doc["date"]
    assert doc["graph"] == {"family": "series_parallel", "target_nodes": 20,
                            "seed": 0}
    assert doc["features"] == {"d_pos": 16}
    assert doc["fleets"] == {
        "nvlink_island": {"builder": "nvlink_island",
                          "args": {"islands": 2, "gpus_per_island": 2}},
        "multi_host": {"builder": "multi_host",
                       "args": {"hosts": 2, "gpus_per_host": 2}},
        "torus": {"builder": "torus", "args": {"rows": 2, "cols": 2}},
        "ring": {"builder": "ring", "args": {"devices": 4}}}
    assert set(doc["dp_bound"]) == set(doc["fleets"])
    assert set(doc["results"]) == set(doc["host_latency"]) == \
        set(smoke.TOPO_CONTRACT)
    for name in smoke.TOPO_CONTRACT:
        bound = doc["dp_bound"][name]
        for part in ("results", "host_latency"):
            row = doc[part][name]
            assert set(row) == {str(s) for s in doc["seeds"]}
            assert all(math.isfinite(x) and bound * (1 - 1e-6) <= x < 1
                       for x in row.values()), (name, part)
            assert all(math.isclose(row[s], doc["results"][name][s],
                                    rel_tol=1e-5) for s in row)


def test_reference_multi_spread_is_chip_smokes_contract():
    """``tools/reference_multi_spread.json``: the joint-training config
    ``chip_smoke.py`` trains the port with, the three paper graphs' joint
    bests and BERT-base's zero-shot latency after training on the other
    two, finite for seeds 0-11."""
    smoke = _chip_smoke()
    with open(smoke.MULTI_JSON) as f:
        doc = json.load(f)
    assert doc["config"] == smoke.MULTI_CONTRACT_CONFIG
    assert doc["seeds"] == list(range(12))
    assert doc["platform"] == "paper_platform()"
    assert doc["jax_version"] and doc["date"]
    assert doc["joint"] == ["inception_v3", "resnet50", "bert_base"]
    assert doc["transfer_from"] == ["inception_v3", "resnet50"]
    assert doc["transfer_to"] == "bert_base"
    rows = [doc["results"]["joint"][n] for n in doc["joint"]]
    rows.append(doc["results"]["transfer"]["bert_base"])
    for row in rows:
        assert set(row) == {str(s) for s in doc["seeds"]}
        assert all(math.isfinite(x) and 0 < x < 1 for x in row.values())


def _check_corpus_record(smoke, path, spec):
    """A corpus spread JSON at ``chip_smoke.py``'s contract config over
    ``spec``: the port's corpus, graph sequences and finite latencies of
    one greedy pair a graph, two bests and two zero-shot pairs."""
    with open(path) as f:
        doc = json.load(f)
    assert doc["config"] == smoke.CORPUS_CONTRACT_CONFIG
    assert doc["trainer"] == smoke.CORPUS_TRAINER
    assert doc["corpus"] == spec
    assert doc["held_out"] == smoke.HELD_OUT_SPEC
    assert doc["seeds"] == list(range(12))
    assert doc["platform"] == "paper_platform()"
    assert doc["jax_version"] and doc["date"]
    from repro_torch.core import plan_buckets
    from repro_torch.core.train import CurriculumSampler
    from repro_torch.graphs import build_corpus, corpus_fingerprint
    corpus = build_corpus(doc["corpus"])
    assert [g.name for g in corpus] == doc["graphs"]
    assert [g.num_nodes for g in corpus] == doc["num_nodes"]
    assert plan_buckets(doc["num_nodes"], 3) == doc["buckets"]
    assert corpus_fingerprint(corpus) == doc["fingerprint"]
    assert [g.name for g in build_corpus(doc["held_out"])] == \
        doc["held_out_graphs"]
    res = doc["results"]
    assert set(res["greedy"]) == set(doc["graphs"])
    assert set(res["best"]) == {"inception_v3", "resnet50"}
    assert set(res["zero_shot"]) == set(doc["held_out_graphs"])
    pairs = [row for part in ("greedy", "best", "zero_shot")
             for row in res[part].values()]
    assert len(pairs) == len(corpus) + 4
    for row in pairs:
        assert set(row) == {str(s) for s in doc["seeds"]}
        assert all(math.isfinite(x) and x > 0 for x in row.values())
    for s in doc["seeds"]:
        sampler = CurriculumSampler(doc["buckets"], graphs_per_episode=4,
                                    seed=s)
        want = [sampler.sample() for _ in range(doc["config"]
                                                ["max_episodes"])]
        assert [[b, ids] for b, ids in want] == res["sequence"][str(s)]
    return doc


def test_reference_corpus_spread_is_chip_smokes_contract():
    """``tools/reference_corpus_spread.json``: the reference's corpus runs
    at ``chip_smoke.py``'s contract config — its corpus (graphs, sizes,
    buckets, fingerprint) is the port's, each seed's graph sequence is
    what the port's sampler draws for that seed, and every latency of the
    14 pairs is finite for seeds 0-11."""
    smoke = _chip_smoke()
    doc = _check_corpus_record(smoke, smoke.CORPUS_JSON, smoke.CORPUS_SPEC)
    assert len(doc["graphs"]) + 4 == 14


def test_reference_full_corpus_spread_is_chip_smokes_contract():
    """``tools/reference_corpus_spread_full.json``: the same over Table 8's
    full corpus, ``traced`` included (16 pairs), whose fingerprint is the
    one ROADMAP records."""
    smoke = _chip_smoke()
    doc = _check_corpus_record(smoke, smoke.CORPUS_FULL_JSON,
                               smoke.CORPUS_FULL_SPEC)
    assert doc["fingerprint"] == ("9e4ccd26d9574549f9eec9ceb2505e56"
                                  "2d16d0d59993868095c719bcd6b1f2d7")
    assert len(doc["graphs"]) + 4 == 16


def test_reference_baseline_spread_is_chip_smokes_contract():
    """``tools/reference_baseline_spread.json``: the reference's Placeto and
    RNN searches over seeds 0-11 on the three paper graphs at
    ``chip_smoke.py``'s contract config, every best latency finite."""
    smoke = _chip_smoke()
    with open(smoke.BASELINE_JSON) as f:
        doc = json.load(f)
    assert doc["config"] == smoke.BASELINE_CONTRACT_CONFIG
    assert doc["feature"] == smoke.BASELINE_FEATURE
    assert doc["seeds"] == list(range(12))
    assert doc["platform"] == "paper_platform()"
    assert doc["jax_version"] and doc["date"]
    assert set(doc["results"]) == {"inception_v3", "resnet50", "bert_base"}
    for name, row in doc["results"].items():
        assert set(row) == {"placeto", "rnn"}, name
        for method, by_seed in row.items():
            assert set(by_seed) == {str(s) for s in doc["seeds"]}
            assert all(math.isfinite(x) and 0 < x < 1
                       for x in by_seed.values()), (name, method)
