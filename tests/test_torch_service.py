"""Port parity, the warm placement service: ``repro_torch.api.
PlacementService`` against ``repro.api.PlacementService`` on one
checkpoint (the reference fits it, both packages load it): on a
mixed-bucket stream with repeats and an out-of-vocabulary graph the same
placements, the same exception types in the same slots and ``stats()``
equal key by key, with and without the AOT cache; ``place_many``'s
``PlacementRequestError`` word for word; then the port's own cases (the
session's placements, slot invariance, duplicates, LRU eviction, the
raise before any counter moves, a policy replaced under a warm entry, the
constructor's checks and its device)."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as refapi  # noqa: E402
from repro.core import CompGraph as RefGraph  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.graphs import build_corpus as ref_build_corpus  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.checkpoint import params_to_numpy  # noqa: E402
from repro_torch.core import CompGraph  # noqa: E402
from repro_torch.graphs import build_corpus  # noqa: E402

#: the reference's serving tests' policy (``tests/test_server.py``)
WL = "synthetic:family=mixed:count=4:size=12:seed=6"
#: at granularity 8 the four graphs fall in three buckets, (16, 16) twice
GRAN = 8
#: graph indices of the stream; -1 is the out-of-vocabulary graph
STREAM = [0, 1, 2, 3, 0, -1, 3, 0, 2, 1, 0, 3]


def _oov_graph(cls):
    """An op type no synthetic family emits: fails vocab validation."""
    g = cls("oov")
    g.add_op("in", "Parameter", output_shape=(1, 4), flops=0, bytes_out=16)
    g.add_op("sm", "Softmax", ["in"], (1, 4), flops=10, bytes_out=16)
    return g


@pytest.fixture(scope="module")
def policy(tmp_path_factory):
    """The reference fits ``tests/test_server.py``'s session and saves it;
    the port loads it on the CPU."""
    d = str(tmp_path_factory.mktemp("policy"))
    ref = refapi.PlacementSession(refapi.PlacementSpec(
        workload=WL, mode="corpus",
        config=RefConfig(num_devices=2, hidden_channel=16, max_episodes=1,
                         update_timestep=3, batch_chains=2),
        max_buckets=2, graphs_per_episode=2))
    ref.fit()
    ref.save(d)
    ref_graphs, graphs = ref_build_corpus(WL), build_corpus(WL)
    return SimpleNamespace(
        dir=d, port=api.PlacementSession.load(d, device="cpu"),
        ref_graphs=ref_graphs, graphs=graphs,
        ref_stream=[ref_graphs[i] if i >= 0 else _oov_graph(RefGraph)
                    for i in STREAM],
        stream=[graphs[i] if i >= 0 else _oov_graph(CompGraph)
                for i in STREAM])


def _services(policy, tmp_path, aot, **kw):
    """(reference, port) services on the checkpoint, each with its own
    AOT directory when ``aot``."""
    kw = dict(batch_slots=2, size_granularity=GRAN, **kw)
    return (refapi.PlacementService(
                policy.dir, aot_cache=str(tmp_path / "ref") if aot else None,
                **kw),
            api.PlacementService(
                policy.dir, aot_cache=str(tmp_path / "port") if aot else None,
                device="cpu", **kw))


@pytest.mark.parametrize("aot", [False, True], ids=["no_aot", "aot"])
def test_a_mixed_stream_is_served_as_the_reference_serves_it(policy,
                                                             tmp_path, aot):
    ref, port = _services(policy, tmp_path, aot)
    want = ref.place_many(policy.ref_stream, return_exceptions=True)
    got = port.place_many(policy.stream, return_exceptions=True)
    for i, (w, g) in enumerate(zip(want, got)):
        if isinstance(w, Exception):
            assert type(g) is type(w) and str(g) == str(w), i
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    # a second pass is all warm: LRU hits, no new cold bucket
    for g, w in zip(port.place_many(policy.graphs),
                    ref.place_many(policy.ref_graphs)):
        np.testing.assert_array_equal(g, w)
    assert port.stats() == ref.stats()
    assert port.stats()["shape_keys_seen"] == 3
    for g, rg in zip(policy.graphs, policy.ref_graphs):
        (p, lat), (rp, rlat) = port.evaluate(g), ref.evaluate(rg)
        np.testing.assert_array_equal(p, rp)
        assert lat == pytest.approx(rlat, rel=1e-12, abs=0)
    assert port.stats() == ref.stats()


def test_place_many_raises_the_references_error(policy, tmp_path):
    ref, port = _services(policy, tmp_path, False)
    with pytest.raises(refapi.PlacementRequestError) as want:
        ref.place_many(policy.ref_stream)
    with pytest.raises(api.PlacementRequestError) as got:
        port.place_many(policy.stream)
    assert str(got.value) == str(want.value)
    assert sorted(got.value.failures) == sorted(want.value.failures) == [5]
    assert port.stats() == ref.stats()
    assert port.stats()["requests"] == 0 and port.stats()["failed"] == 1


def test_served_placements_are_the_sessions(policy):
    service = api.PlacementService(policy.port, batch_slots=4,
                                   size_granularity=16)
    for g in policy.graphs:
        np.testing.assert_array_equal(service.place(g),
                                      policy.port.place(g))
    assert service.device == torch.device("cpu")


@pytest.mark.parametrize("case", ["permutations", "duplicates"])
def test_a_placement_does_not_depend_on_its_slot(policy, case):
    """One bucket for all (granularity 64): solo, forward and backward
    bursts agree; duplicates in one burst featurise once."""
    service = api.PlacementService(policy.port, batch_slots=4,
                                   size_granularity=64)
    graphs = policy.graphs
    solo = [policy.port.place(g) for g in graphs]
    if case == "permutations":
        bursts = [service.place_many(graphs),
                  service.place_many(graphs[::-1])[::-1]]
        for burst in bursts:
            for g, a, b in zip(graphs, solo, burst):
                np.testing.assert_array_equal(a, b, err_msg=g.name)
    else:
        g0, g1 = graphs[0], graphs[1]
        out = service.place_many([g0, g0, g1, g0])
        assert (service.cache_misses, service.cache_hits) == (2, 2)
        for k in (0, 1, 3):
            np.testing.assert_array_equal(out[k], solo[0])
        np.testing.assert_array_equal(out[2], solo[1])
        assert out[0].shape == (g0.num_nodes,)
    assert service.stats()["shape_keys_seen"] == 1


def test_the_lru_evicts_beyond_capacity(policy):
    service = api.PlacementService(policy.port, cache_size=2, batch_slots=1,
                                   size_granularity=32)
    for g in policy.graphs:
        service.place(g)
    assert service.stats()["cached_graphs"] == 2
    service.place(policy.graphs[0])        # evicted: featurised again
    assert (service.cache_misses, service.cache_hits) == (5, 0)
    service.place(policy.graphs[0])
    assert service.cache_hits == 1


def test_an_invalid_request_raises_before_counters_move(policy):
    service = api.PlacementService(policy.port, batch_slots=2,
                                   size_granularity=32)
    g0, g1 = policy.graphs[:2]
    with pytest.raises(api.PlacementRequestError, match="oov.*Softmax"):
        service.place_many([g0, _oov_graph(CompGraph), g1])
    assert (service.stats()["requests"], service.stats()["failed"]) == (0, 1)
    # the valid requests' prepared entries were kept
    service.place_many([g0, g1])
    assert service.cache_hits == 2 and service.stats()["requests"] == 2
    out = service.place_many([g0, _oov_graph(CompGraph)],
                             return_exceptions=True)
    assert isinstance(out[1], ValueError) and "Softmax" in str(out[1])
    np.testing.assert_array_equal(out[0], policy.port.place(g0))


def test_a_replaced_policy_is_served_at_once(policy):
    """A warm entry's engine follows the session's policy when
    ``load_params`` (or a refit) replaces it."""
    session = api.PlacementSession.load(policy.dir, device="cpu")
    service = api.PlacementService(session, batch_slots=2,
                                   size_granularity=32)
    g = policy.graphs[2]
    service.place(g)

    def negate(tree):
        if isinstance(tree, dict):
            return {k: negate(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [negate(v) for v in tree]
        return -tree

    session.trainer.load_params(negate(params_to_numpy(
        session.trainer.policy)))
    np.testing.assert_array_equal(service.place(g), session.place(g))
    assert service.cache_hits == 1


@pytest.mark.parametrize("kw", [dict(cache_size=0), dict(batch_slots=0),
                                dict(size_granularity=0)])
def test_the_constructors_checks(policy, kw):
    with pytest.raises(ValueError, match="must all be >= 1"):
        api.PlacementService(policy.port, **kw)


def test_an_unfitted_session_is_refused():
    with pytest.raises(ValueError, match="no trained policy"):
        api.PlacementService(api.PlacementSession(device="cpu"))


def test_a_checkpoint_loads_on_the_named_device(policy):
    service = api.PlacementService(policy.dir, device="cpu")
    assert service.session.graphs == []    # the corpus is not rebuilt
    assert service.device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.PlacementService(policy.dir)
