"""Port parity, the v1 API and the stage planner: ``PlacementSpec``'s
canonical JSON and ``spec_hash`` bitwise the reference's, its errors word
for word, the platform registry and ``tpu_stage_platform`` bitwise,
``_monotone_projection`` and ``plan_stages``' even-split baseline exact,
``PlacementSession.fit`` equal to the direct trainers in each mode, and
session checkpoints crossing between the packages with the same greedy
placements."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as refapi  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.core import costmodel as refcm  # noqa: E402
from repro.core import extract_features as ref_extract  # noqa: E402
from repro.core import planner as refplan  # noqa: E402
from repro.configs import get as ref_arch  # noqa: E402
from repro.core.features import \
    shared_feature_config as ref_shared  # noqa: E402
from repro.core.graph import \
    topological_order as ref_topological_order  # noqa: E402
from repro.core.hsdag import MultiGraphTrainer as RefMulti  # noqa: E402
from repro.core.train.population import \
    PopulationConfig as RefPopulation  # noqa: E402
from repro.graphs import build_corpus as ref_build_corpus  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.checkpoint import params_to_numpy  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import (HSDAG, CurriculumTrainer,  # noqa: E402
                              HSDAGConfig, MultiGraphTrainer,
                              PopulationConfig, extract_features,
                              paper_platform, planner, tpu_stage_platform)
from repro_torch.graphs import build_corpus  # noqa: E402

#: a few synthetic graphs: each fit in a few seconds on the CPU
WORKLOAD = "synthetic:family=layered+series_parallel:count=2:size=12:seed=1"


def _spec_pairs():
    """The same documents in both packages."""
    def both(**kw):
        out = []
        for mod, cfg_cls, pop_cls in ((refapi, RefConfig, RefPopulation),
                                      (api, HSDAGConfig, PopulationConfig)):
            k = dict(kw)
            if "config" in k:
                k["config"] = cfg_cls(**k["config"])
            if "population" in k:
                k["population"] = pop_cls(**k["population"])
            out.append(mod.PlacementSpec(**k))
        return out
    return [
        both(workload="benchmark"),
        both(workload="benchmark:names=bert_base", mode="search",
             config={"batch_chains": 8, "seed": 3}, episodes=5,
             head="dense", feature={"d_pos": 16}),
        both(workload="synthetic:count=3:size=9", mode="multi",
             platform="nvlink_island",
             platform_args={"islands": 2, "gpus_per_island": 2},
             config={"num_devices": 4, "head": "device"},
             reward_norm="none"),
        both(workload="stream:synthetic:count=30:size=20", mode="corpus",
             platform="tpu_stage", platform_args={"num_stages": 3},
             max_buckets=3, graphs_per_episode=2, sampler="plateau",
             checkpoint_dir="ckpt", checkpoint_every=2, stream=True,
             mesh=[1, 1], prefetch="off",
             population={"cull_every": 1, "greedy_restart_every": 2}),
        both(workload="", platform="ring", platform_args={"devices": 4}),
    ]


@pytest.mark.parametrize("pair", range(5))
def test_spec_json_and_hash_are_the_references(pair):
    ref, mine = _spec_pairs()[pair]
    assert mine.to_json() == ref.to_json()
    assert mine.spec_hash() == ref.spec_hash()
    back = api.PlacementSpec.from_json(mine.to_json())
    assert back == mine and back.spec_hash() == mine.spec_hash()
    # the reference's document reads in the port and hashes the same
    assert api.PlacementSpec.from_json(ref.to_json()).spec_hash() == \
        ref.spec_hash()


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("kw", [
    {"workload": "benchmark", "mode": "serve"},
    {"workload": "benchmark", "platform": "laptop"},
    {"workload": "benchmark;warp:count=2"},
    {"workload": "benchmark", "feature": {"op_vocab": ["x"]}},
    {"workload": "benchmark", "sampler": "random"},
    {"workload": "benchmark", "mode": "search", "checkpoint_every": 2},
    {"workload": "benchmark", "mesh": [0, 1]},
    {"workload": "benchmark", "episodes": 0},
    {"workload": "benchmark", "head": "sparse"},
    {"workload": "benchmark", "prefetch": "maybe"},
    {"workload": "benchmark", "reward_norm": "zscore"},
    {"workload": "eager:benchmark", "mode": "corpus", "stream": True},
])
def test_spec_errors_are_the_references(kw):
    assert _message(lambda: api.PlacementSpec(**kw)) == \
        _message(lambda: refapi.PlacementSpec(**kw))


def test_from_json_rejects_unknown_fields_as_the_reference():
    doc = json.loads(api.PlacementSpec(workload="benchmark").to_json())
    for bad in ({**doc, "warp": 1, "speed": 2}, {**doc, "version": 2},
                "[1, 2]"):
        assert _message(lambda: api.PlacementSpec.from_json(bad)) == \
            _message(lambda: refapi.PlacementSpec.from_json(bad))
    assert "unknown PlacementSpec fields ['speed', 'warp']" in \
        _message(lambda: api.PlacementSpec.from_json(
            {**doc, "warp": 1, "speed": 2}))


@pytest.mark.parametrize("text", [
    "nvlink_island:islands=2:gpus_per_island=4", "tpu_stage:num_stages=3",
    "paper", "torus:rows=2:cols=2", "ring:devices=3", "multi_host"])
def test_platform_registry_builds_the_references_platforms(text):
    assert api.platform_names() == refapi.platform_names()
    name, args = api.parse_platform_spec(text)
    assert (name, args) == refapi.parse_platform_spec(text)
    mine = api.build_platform(api.PlacementSpec(
        workload="", platform=name, platform_args=args))
    ref = refapi.build_platform(refapi.PlacementSpec(
        workload="", platform=name, platform_args=args))
    assert [dataclasses.astuple(d) for d in mine.devices] == \
        [dataclasses.astuple(d) for d in ref.devices]
    for a, b in ((mine.link_bw, ref.link_bw),
                 (mine.link_latency, ref.link_latency)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text", ["", "warp", "paper:", "paper:x",
                                  "paper:=1", "paper:a=1:a=2"])
def test_platform_spec_errors_are_the_references(text):
    assert _message(lambda: api.parse_platform_spec(text)) == \
        _message(lambda: refapi.parse_platform_spec(text))


@pytest.mark.parametrize("kw", [{}, {"num_stages": 4, "chips_per_stage": 64,
                                     "inter_stage_bw": 1e10}])
def test_tpu_stage_platform_is_the_references(kw):
    mine, ref = tpu_stage_platform(**kw), refcm.tpu_stage_platform(**kw)
    assert [dataclasses.astuple(d) for d in mine.devices] == \
        [dataclasses.astuple(d) for d in ref.devices]
    np.testing.assert_array_equal(mine.link_bw, ref.link_bw)
    np.testing.assert_array_equal(mine.link_latency, ref.link_latency)


def test_monotone_projection_and_the_even_split_are_the_references():
    rng = np.random.default_rng(0)
    for n, stages in ((9, 2), (30, 4)):
        order = rng.permutation(n)
        p = rng.integers(0, stages, n)
        np.testing.assert_array_equal(
            planner._monotone_projection(p, order, stages),
            refplan._monotone_projection(p, order, stages))
    cfg = get("phi3-mini-3.8b").smoke_config
    plan = planner.plan_stages(
        cfg, seq_len=64, batch=2, num_stages=2,
        hsdag_cfg=HSDAGConfig(num_devices=2, max_episodes=1,
                              update_timestep=3, hidden_channel=16),
        device="cpu")
    # the reference's even split of its own layer graph
    rg = refplan.layer_graph(ref_arch("phi3-mini-3.8b").smoke_config, 64, 2,
                             "train")
    order = ref_topological_order(rg)
    even = np.minimum((np.arange(rg.num_nodes) * 2) // rg.num_nodes, 1)
    even = refplan._monotone_projection(even, order, 2)
    plat = refcm.tpu_stage_platform(num_stages=2)
    assert plan.baseline_latency == refcm.simulate(
        rg, even, plat, order=order).latency
    assert plan.latency == refcm.simulate(rg, plan.stage_of_node, plat,
                                          order=order).latency
    stages = plan.stage_of_node[order]
    assert np.all(np.diff(stages) >= 0)
    assert plan.boundaries == [i for i in range(1, rg.num_nodes)
                               if stages[i] != stages[i - 1]]


def _tiny(**kw):
    return HSDAGConfig(**{"num_devices": 2, "batch_chains": 2,
                          "max_episodes": 2, "update_timestep": 3,
                          "hidden_channel": 16, **kw})


def _same_policy(a, b):
    for x, y in zip(jax.tree.leaves(params_to_numpy(a)),
                    jax.tree.leaves(params_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


def test_fit_search_is_hsdag_search():
    graphs = build_corpus(WORKLOAD)[:1]
    plat = paper_platform()
    session = api.PlacementSession(api.PlacementSpec(
        workload="", mode="search", config=_tiny()), device="cpu")
    res = session.fit(graphs=graphs, platform=plat, rng=5)
    fc = session.feature_config
    agent = HSDAG(_tiny(seed=5), device="cpu")
    want = agent.search(graphs[0], extract_features(graphs[0], fc),
                        platform=plat)
    np.testing.assert_array_equal(res.best_placement, want.best_placement)
    assert res.best_latency == want.best_latency
    _same_policy(session.params, agent.policy)
    p, lat = session.evaluate(graphs[0])
    np.testing.assert_array_equal(p, agent.place(
        extract_features(graphs[0], fc)))


def test_fit_multi_and_corpus_are_the_trainers():
    graphs = build_corpus(WORKLOAD)
    plat = paper_platform()
    res = api.PlacementSession(api.PlacementSpec(
        workload=WORKLOAD, mode="multi", config=_tiny()),
        device="cpu").fit()
    trainer = MultiGraphTrainer(_tiny(), device="cpu")
    want = trainer.train(graphs, platform=plat)
    np.testing.assert_array_equal(res.best_latencies, want.best_latencies)
    _same_policy(res.params, want.params)

    spec = api.PlacementSpec(workload=WORKLOAD, mode="corpus",
                             config=_tiny(), max_buckets=2,
                             graphs_per_episode=2, prefetch="off")
    res = api.PlacementSession(spec, device="cpu").fit(rng=4)
    trainer = CurriculumTrainer(_tiny(), max_buckets=2, graphs_per_episode=2,
                                prefetch="off", device="cpu")
    want = trainer.train_corpus(graphs, platform=plat, rng=4)
    np.testing.assert_array_equal(res.best_latencies, want.best_latencies)
    np.testing.assert_array_equal(res.greedy_latencies,
                                  want.greedy_latencies)
    _same_policy(res.params, want.params)
    # a v1 spec's "mesh": [1, 1] trains on the sharded engine's 1×1 mesh,
    # bit for bit the unsharded run
    meshed = api.PlacementSession(dataclasses.replace(spec, mesh=[1, 1]),
                                  device="cpu")
    res = meshed.fit(rng=4)
    assert meshed.trainer.mesh_shape == (1, 1)
    np.testing.assert_array_equal(res.best_latencies, want.best_latencies)
    np.testing.assert_array_equal(res.greedy_latencies,
                                  want.greedy_latencies)
    _same_policy(res.params, want.params)


def test_fit_argument_checks():
    session = api.PlacementSession(device="cpu")
    with pytest.raises(ValueError, match="no spec"):
        session.fit()
    with pytest.raises(ValueError, match="workload is empty"):
        session.fit(api.PlacementSpec(workload="", config=_tiny()))
    with pytest.raises(ValueError, match="exactly one graph"):
        session.fit(api.PlacementSpec(workload=WORKLOAD, config=_tiny()))
    with pytest.raises(ValueError, match="reward_fn= only applies"):
        session.fit(api.PlacementSpec(workload=WORKLOAD, mode="multi",
                                      config=_tiny()),
                    reward_fn=lambda p: (1.0, 1.0))
    with pytest.raises(ValueError, match="no trained policy"):
        api.PlacementSession(device="cpu").place(build_corpus(WORKLOAD)[0])


def test_session_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint the reference's ``PlacementSession.save`` wrote loads in
    the port and greedy-places identically, and the port's loads in the
    reference."""
    graphs = build_corpus(WORKLOAD)
    ref_graphs = ref_build_corpus(WORKLOAD)
    cfg = dict(num_devices=2, batch_chains=2, max_episodes=1,
               update_timestep=2, hidden_channel=16, seed=2)
    ref_spec = refapi.PlacementSpec(workload=WORKLOAD, mode="multi",
                                    config=RefConfig(**cfg))
    ref = refapi.PlacementSession(ref_spec)
    fc = ref_shared(ref_graphs)
    trainer = RefMulti(ref_spec.resolved_config())
    trainer.init(jax.random.PRNGKey(2), ref_extract(ref_graphs[0], fc))
    trainer.feature_config = fc
    ref.trainer, ref.graphs = trainer, ref_graphs
    ref.save(str(tmp_path / "ref"))

    mine = api.PlacementSession.load(str(tmp_path / "ref"), device="cpu")
    assert mine.spec.spec_hash() == ref_spec.spec_hash()
    back = refapi.PlacementSession.load(str(tmp_path / "ref"))
    for g, rg in zip(graphs, ref_graphs):
        np.testing.assert_array_equal(mine.place(g), back.place(rg))

    mine.graphs = graphs
    mine.save(str(tmp_path / "port"))
    manifest = json.load(open(next((tmp_path / "port").rglob(
        "manifest.json"))))
    ref_manifest = json.load(open(next((tmp_path / "ref").rglob(
        "manifest.json"))))
    for key in ("placement_spec", "spec_hash", "corpus_fingerprint",
                "config", "engine"):
        assert manifest[key] == ref_manifest[key], key
    again = refapi.PlacementSession.load(str(tmp_path / "port"))
    for g, rg in zip(graphs, ref_graphs):
        np.testing.assert_array_equal(again.place(rg), mine.place(g))
