"""The port's platforms subsystem, baselines and synthetic graphs against the
reference's: topology builders and their validation messages, the device
feature table, the exact series-parallel DP and its hybrid refiner, and the
three synthetic DAG families — all numpy copies, so every array is compared
bit for bit and every placement exactly."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import CompGraph as RefGraph  # noqa: E402
from repro.core import baselines as ref_baselines  # noqa: E402
from repro.graphs import synthetic as ref_synthetic  # noqa: E402
from repro import platforms as ref_platforms  # noqa: E402

from repro_torch.core import CompGraph, baselines  # noqa: E402
from repro_torch.graphs import synthetic  # noqa: E402
from repro_torch import platforms  # noqa: E402

_Q = 16

BUILDS = [
    ("nvlink_island", dict(islands=2, gpus_per_island=2)),
    ("nvlink_island", dict(islands=2, gpus_per_island=4)),
    ("nvlink_island", dict(islands=3, gpus_per_island=2, island_scale=0.5,
                           parallel_queues=2)),
    ("nvlink_island", dict(islands=2, gpus_per_island=4, mem_capacity=128e6,
                           island_scale=0.04)),
    ("multi_host", dict(hosts=2, gpus_per_host=2)),
    ("multi_host", dict(hosts=3, gpus_per_host=3, nic_lat=1e-5)),
    ("torus", dict(rows=2, cols=2)),
    ("torus", dict(rows=2, cols=4, parallel_queues=_Q)),
    ("torus", dict(rows=3, cols=3)),
    ("ring", dict(devices=4)),
    ("ring", dict(devices=5, link_bw=10e9)),
    ("ring", dict(devices=1)),
]


def _same_platform(mine, want):
    assert [dataclasses.asdict(d) for d in mine.devices] == \
        [dataclasses.asdict(d) for d in want.devices]
    for attr in ("link_bw", "link_latency", "coords"):
        a, b = np.asarray(getattr(mine, attr)), np.asarray(getattr(want, attr))
        assert a.dtype == b.dtype and a.shape == b.shape, attr
        assert a.tobytes() == b.tobytes(), attr


@pytest.mark.parametrize("name,kw", BUILDS)
def test_builders_and_feature_table_are_the_references(name, kw):
    mine = getattr(platforms, name)(**kw)
    want = getattr(ref_platforms, name)(**kw)
    _same_platform(mine, want)
    a = platforms.device_feature_table(mine)
    b = ref_platforms.device_feature_table(want)
    assert a.dtype == b.dtype == np.float32
    assert a.shape == (mine.num_devices, platforms.DEV_FEATURE_DIM)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("fn_name,kw", [
    ("nvlink_island", dict(islands=0)),
    ("nvlink_island", dict(gpus_per_island=0)),
    ("nvlink_island", dict(island_scale=1.5)),
    ("nvlink_island", dict(island_scale=0.0)),
    ("multi_host", dict(hosts=0)),
    ("torus", dict(cols=0)),
    ("ring", dict(devices=0)),
    ("LinkTier", dict(name="bad", bandwidth=0.0, latency=1e-6)),
    ("LinkTier", dict(name="bad", bandwidth=float("inf"), latency=1e-6)),
    ("LinkTier", dict(name="bad", bandwidth=1e9, latency=-1.0)),
])
def test_builder_validation_messages_are_the_references(fn_name, kw):
    errors = []
    for mod in (platforms, ref_platforms):
        with pytest.raises(ValueError) as info:
            getattr(mod, fn_name)(**kw)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_topology_validation_messages_are_the_references():
    for tier_index, coords in ((np.array([[0, 7], [0, 0]]), np.zeros((2, 1))),
                               (np.zeros((3, 3), int), np.zeros((2, 1))),
                               (np.zeros((2, 2), int), np.zeros((3, 1)))):
        errors = []
        for mod in (platforms, ref_platforms):
            dev = mod.nvlink_island(islands=1, gpus_per_island=2).devices
            with pytest.raises(ValueError) as info:
                mod.Topology(devices=dev,
                             tiers=(mod.LinkTier("x", 1e9, 0.0),),
                             tier_index=tier_index, coords=coords)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


def _same_graph(mine, want):
    assert mine.name == want.name and mine.num_nodes == want.num_nodes
    assert [dataclasses.asdict(n) for n in mine.nodes] == \
        [dataclasses.asdict(n) for n in want.nodes]
    np.testing.assert_array_equal(mine.edges, want.edges)


@pytest.mark.parametrize("family,kw", [
    ("layered", dict(num_layers=6, width=5, p_skip=0.3)),
    ("layered", dict()),
    ("series_parallel", dict(target_nodes=20)),
    ("series_parallel", dict(target_nodes=60, flops_scale=3.0)),
    ("branch_join", dict(num_blocks=3, branches=4, depth=2)),
    ("branch_join", dict(num_blocks=2, branches=3, depth=3,
                         op_mix=(("MatMul", 1.0), ("ReLU", 1.0)))),
])
def test_synthetic_families_build_the_references_graphs(family, kw):
    assert set(synthetic.SYNTHETIC_FAMILIES) == \
        set(ref_synthetic.SYNTHETIC_FAMILIES)
    assert synthetic.DEFAULT_OP_MIX == ref_synthetic.DEFAULT_OP_MIX
    for seed in (0, 1, 5):
        _same_graph(synthetic.SYNTHETIC_FAMILIES[family](seed=seed, **kw),
                    ref_synthetic.SYNTHETIC_FAMILIES[family](seed=seed, **kw))


def test_synthetic_argument_errors_are_the_references():
    for name, kw in (("layered_dag", dict(num_layers=0)),
                     ("series_parallel_dag", dict(target_nodes=0)),
                     ("branch_join_dag", dict(depth=0))):
        errors = []
        for mod in (synthetic, ref_synthetic):
            with pytest.raises(ValueError) as info:
                getattr(mod, name)(**kw)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


def _pair_of_fleets(name, kw):
    return getattr(platforms, name)(**kw), getattr(ref_platforms, name)(**kw)


FLEETS = [("nvlink_island", dict(islands=2, gpus_per_island=2)),
          ("multi_host", dict(hosts=2, gpus_per_host=2)),
          ("torus", dict(rows=2, cols=2)),
          ("ring", dict(devices=4)),
          ("nvlink_island", dict(islands=2, gpus_per_island=2,
                                 island_scale=0.5, parallel_queues=_Q))]


@pytest.mark.parametrize("name,kw", FLEETS)
def test_exact_dp_and_hybrid_are_the_references(name, kw):
    """``sp_decompose``, ``dp_optimal``, ``hybrid_refine`` and the two
    baselines on series-parallel DAGs of seeds 0-3: the same placements,
    bounds and latencies, bit for bit."""
    plat, ref_plat = _pair_of_fleets(name, kw)
    for seed in range(4):
        g = synthetic.series_parallel_dag(target_nodes=20, seed=seed)
        rg = ref_synthetic.series_parallel_dag(target_nodes=20, seed=seed)
        edges = platforms.sp_decompose(g)
        ref_edges = ref_platforms.sp_decompose(rg)
        assert (edges is None) == (ref_edges is None)
        assert [(e.u, e.v) for e in edges] == [(e.u, e.v) for e in ref_edges]
        mine, want = platforms.dp_optimal(g, plat), \
            ref_platforms.dp_optimal(rg, ref_plat)
        np.testing.assert_array_equal(mine.placement, want.placement)
        assert (mine.latency, mine.bound, mine.oom) == \
            (want.latency, want.bound, want.oom)
        p, lat = baselines.dp_placement(g, plat)
        rp, rlat = ref_baselines.dp_placement(rg, ref_plat)
        np.testing.assert_array_equal(p, rp)
        assert lat == rlat
        rng = np.random.default_rng(seed)
        for _ in range(3):
            start = rng.integers(0, plat.num_devices, g.num_nodes)
            mine = platforms.hybrid_refine(g, start, plat)
            want = ref_platforms.hybrid_refine(rg, start, ref_plat)
            np.testing.assert_array_equal(mine.placement, want.placement)
            assert (mine.latency, mine.bound, mine.oom) == \
                (want.latency, want.bound, want.oom)
            p, lat = baselines.hybrid_placement(g, start, plat)
            rp, rlat = ref_baselines.hybrid_placement(rg, start, ref_plat)
            np.testing.assert_array_equal(p, rp)
            assert lat == rlat


def _chain(cls):
    g = cls("chain")
    prev = None
    for i in range(8):
        g.add_op(f"n{i}", "MatMul", [prev] if prev else [], (1, 32),
                 flops=float(1e6 * (i + 1)), bytes_out=128.0)
        prev = f"n{i}"
    return g


def test_pure_chain_dp_and_hybrid_are_the_references():
    kw = dict(islands=2, gpus_per_island=1, parallel_queues=_Q)
    plat, ref_plat = _pair_of_fleets("nvlink_island", kw)
    g, rg = _chain(CompGraph), _chain(RefGraph)
    p, opt = baselines.dp_placement(g, plat)
    rp, ref_opt = ref_baselines.dp_placement(rg, ref_plat)
    np.testing.assert_array_equal(p, rp)
    assert opt == ref_opt
    for start in (np.ones(8, int), np.zeros(8, int)):
        p, lat = baselines.hybrid_placement(g, start, plat)
        rp, rlat = ref_baselines.hybrid_placement(rg, start, ref_plat)
        np.testing.assert_array_equal(p, rp)
        assert lat == rlat
        assert lat == pytest.approx(opt, rel=1e-9)


def _non_sp_graph(cls):
    """The forbidden "N" minor: diamond with a cross edge a→b."""
    g = cls("n-graph")
    g.add_op("s", "Parameter", output_shape=(1, 8), flops=0, bytes_out=32)
    g.add_op("a", "MatMul", ["s"], (1, 8), flops=1e6, bytes_out=32)
    g.add_op("b", "MatMul", ["s", "a"], (1, 8), flops=1e6, bytes_out=32)
    g.add_op("t", "Add", ["a", "b"], (1, 8), flops=8, bytes_out=32)
    return g


def test_non_sp_graph_gives_none_and_the_references_error():
    kw = dict(devices=2, parallel_queues=_Q)
    plat, ref_plat = _pair_of_fleets("ring", kw)
    g, rg = _non_sp_graph(CompGraph), _non_sp_graph(RefGraph)
    assert platforms.sp_decompose(g) is None
    assert ref_platforms.sp_decompose(rg) is None
    assert platforms.dp_optimal(g, plat) is None
    errors = []
    for fn, graph, fleet in ((baselines.dp_placement, g, plat),
                             (ref_baselines.dp_placement, rg, ref_plat)):
        with pytest.raises(ValueError) as info:
            fn(graph, fleet)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    # the hybrid refiner still applies off the SP class
    start = np.array([0, 1, 0, 1])
    mine = platforms.hybrid_refine(g, start, plat)
    want = ref_platforms.hybrid_refine(rg, start, ref_plat)
    np.testing.assert_array_equal(mine.placement, want.placement)
    assert mine.latency == want.latency


def test_heuristic_baselines_are_the_references():
    g = synthetic.series_parallel_dag(target_nodes=12, seed=2)
    rg = ref_synthetic.series_parallel_dag(target_nodes=12, seed=2)
    for name in ("cpu_only", "gpu_only"):
        a, b = getattr(baselines, name)(g), getattr(ref_baselines, name)(rg)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for pref in (0, 1):
        a, fa = baselines.openvino_auto(g, pref)
        b, fb = ref_baselines.openvino_auto(rg, pref)
        np.testing.assert_array_equal(a, b)
        assert fa == fb
