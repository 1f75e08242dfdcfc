"""Port parity, ``scan`` and ``reference`` simulators: the port's scan
backend (the level kernel's plain version on tables of one node a row)
against the reference's ``simulate_jax`` on the same placements, against the
golden latencies and, on the level schedule, against the level backend; the
port's host reference backend against its own ``simulate`` and the
reference's backend, exactly."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.costmodel import DeviceSpec as RefDeviceSpec  # noqa: E402
from repro.core.costmodel import Platform as RefPlatform  # noqa: E402
from repro.core.costmodel import paper_platform as ref_paper  # noqa: E402
from repro.core.costmodel import simulate_batch as ref_simulate_batch  # noqa: E402
from repro.core.sim import ReferenceBackend as RefReferenceBackend  # noqa: E402
from repro.graphs import PAPER_BENCHMARKS as REF_GRAPHS  # noqa: E402

from repro_torch.core import (DeviceSpec, LevelBackend, Platform,  # noqa: E402
                              ReferenceBackend, ScanBackend, get_backend,
                              paper_platform, simulate)
from repro_torch.core.costmodel import sim_arrays  # noqa: E402
from repro_torch.kernels import build_chain_arrays, level_makespan  # noqa: E402

from conftest import CompGraph, make_diamond, random_dag  # noqa: E402
from test_golden_latency import GOLDEN  # noqa: E402
from test_torch_levelsim import _four_devices  # noqa: E402

RTOL = 1e-5     # the reference's own cross-backend tolerance (f32 vs f64)


def _graph(name):
    if name == "diamond":
        return make_diamond()
    if name.startswith("random"):
        n = int(name[len("random"):])
        return random_dag(np.random.default_rng(n), n)
    return REF_GRAPHS[name]()


def _platforms(devices):
    if devices == 2:
        return paper_platform(), ref_paper()
    return (_four_devices(DeviceSpec, Platform),
            _four_devices(RefDeviceSpec, RefPlatform))


def _small_memory(spec_cls, platform_cls):
    """Two devices, the first holding 100 bytes: most placements that put
    the diamond's activations on it run out of memory."""
    devs = (spec_cls("small", "gpu", peak_flops=1e12, mem_bw=1e11,
                     dispatch_overhead=1e-6, mem_capacity=100.0),
            spec_cls("big", "cpu", peak_flops=1e12, mem_bw=1e11,
                     dispatch_overhead=1e-6))
    bw = np.array([[math.inf, 1e10], [1e10, math.inf]])
    return platform_cls(devs, bw, np.array([[0.0, 1e-6], [1e-6, 0.0]]))


def _assert_matches_simulate_jax(g, plat, ref_plat, placements):
    backend = ScanBackend(device="cpu")
    prep = backend.prepare(g, plat)
    assert backend.prepare(g, plat) is prep          # cached per graph
    launches = level_makespan.launches
    got = backend.simulate_batch(prep, placements)
    assert level_makespan.launches == launches      # CPU: the plain version
    want = ref_simulate_batch(g, placements, ref_plat)
    np.testing.assert_allclose(got.latency, np.asarray(want.latency),
                               rtol=RTOL)
    np.testing.assert_allclose(got.transfer_time,
                               np.asarray(want.transfer_time), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(got.per_device_busy,
                               np.asarray(want.per_device_busy), rtol=RTOL)
    np.testing.assert_array_equal(got.oom, np.asarray(want.oom))
    np.testing.assert_array_equal(got.reward == 0,
                                  np.asarray(want.reward) == 0)
    np.testing.assert_allclose(got.reward, np.asarray(want.reward),
                               rtol=RTOL)
    return got


@pytest.mark.parametrize("name,devices", [
    ("inception_v3", 2), ("resnet50", 2), ("bert_base", 2), ("diamond", 2),
    ("random30", 2), ("random57", 2), ("random30", 4), ("resnet50", 4)])
def test_scan_backend_matches_simulate_jax(name, devices):
    g = _graph(name)
    plat, ref_plat = _platforms(devices)
    placements = np.random.default_rng(devices).integers(
        0, devices, (8, g.num_nodes)).astype(np.int32)
    placements[0] = 0
    _assert_matches_simulate_jax(g, plat, ref_plat, placements)


def test_scan_backend_matches_simulate_jax_out_of_memory():
    g = make_diamond()
    placements = np.random.default_rng(3).integers(
        0, 2, (16, g.num_nodes)).astype(np.int32)
    placements[0], placements[1] = 0, 1
    got = _assert_matches_simulate_jax(
        g, _small_memory(DeviceSpec, Platform),
        _small_memory(RefDeviceSpec, RefPlatform), placements)
    assert got.oom[0] and not got.oom[1]


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_scan_backend_reproduces_the_golden_latencies(name):
    g = REF_GRAPHS[name]()
    backend = get_backend("scan", device="cpu")
    res = backend.simulate_batch(
        backend.prepare(g, paper_platform()),
        np.stack([np.zeros(g.num_nodes, int), np.ones(g.num_nodes, int)]))
    np.testing.assert_allclose(res.latency, [GOLDEN[name]["cpu_only"],
                                             GOLDEN[name]["gpu_only"]],
                               rtol=RTOL)


@pytest.mark.parametrize("name", ["inception_v3", "random30", "diamond"])
def test_scan_backend_on_the_level_schedule_is_the_level_backend(name):
    g = _graph(name)
    placements = np.random.default_rng(5).integers(0, 2, (6, g.num_nodes))
    scan = ScanBackend(device="cpu")
    prep = scan.prepare(g, paper_platform(), schedule="level")
    assert prep is not scan.prepare(g, paper_platform())   # own cache entry
    level = LevelBackend(device="cpu")
    lprep = level.prepare(g, paper_platform())
    np.testing.assert_array_equal(scan.schedule_order(prep),
                                  level.schedule_order(lprep))
    got = scan.simulate_batch(prep, placements)
    want = level.simulate_batch(lprep, placements)
    for field in ("latency", "reward", "oom", "per_device_busy",
                  "transfer_time"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


@pytest.mark.parametrize("name", ["resnet50", "diamond", "random30"])
def test_scan_backend_matches_the_host_scheduler_in_topo_order(name):
    g = _graph(name)
    backend = ScanBackend(device="cpu")
    prep = backend.prepare(g, paper_platform())
    order = backend.schedule_order(prep)
    placements = np.random.default_rng(2).integers(0, 2, (5, g.num_nodes))
    res = backend.simulate_batch(prep, placements)
    single = backend.simulate(prep, placements[-1])
    assert single.latency == res.latency[-1]
    np.testing.assert_array_equal(order, sim_arrays(g, paper_platform()).order)
    for i, p in enumerate(placements):
        host = simulate(g, p, paper_platform())      # default order
        np.testing.assert_allclose(res.latency[i], host.latency, rtol=RTOL)
        np.testing.assert_allclose(res.transfer_time[i], host.transfer_time,
                                   rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("name,schedule", [
    ("diamond", "topo"), ("random30", "topo"), ("resnet50", "level"),
    ("random30", "level")])
def test_reference_backend_is_the_host_scheduler(name, schedule):
    g = _graph(name)
    placements = np.random.default_rng(4).integers(0, 2, (4, g.num_nodes))
    backend = get_backend("reference", device="cpu")
    assert isinstance(backend, ReferenceBackend)
    prep = backend.prepare(g, paper_platform(), schedule=schedule)
    order = sim_arrays(g, paper_platform(), schedule=schedule).order
    np.testing.assert_array_equal(backend.schedule_order(prep), order)
    got = backend.simulate_batch(prep, torch.as_tensor(placements))
    ref_backend = RefReferenceBackend()
    ref_prep = ref_backend.prepare(g, ref_paper(), schedule=schedule)
    np.testing.assert_array_equal(ref_backend.schedule_order(ref_prep), order)
    want = ref_backend.simulate_batch(ref_prep, placements)
    for field in ("latency", "reward", "oom", "per_device_busy",
                  "transfer_time"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    for i, p in enumerate(placements):
        host = simulate(g, p, paper_platform(), order=order)
        assert got.latency[i] == host.latency
        assert backend.simulate(prep, p).latency == host.latency
    by_order = backend.prepare(g, paper_platform(), order=order[::-1].copy())
    np.testing.assert_array_equal(by_order.order, order[::-1])


def test_chain_arrays_of_an_edge_free_and_an_all_data_graph():
    free = CompGraph("free")
    for i in range(3):
        free.add_op(f"n{i}", "MatMul", output_shape=(1, 8),
                    flops=float(1e6 * (i + 1)), bytes_out=64.0)
    la = build_chain_arrays(sim_arrays(free, paper_platform()))
    assert la.nodes.shape == (3, 1) and (la.pred_data == 1).all()
    np.testing.assert_array_equal(la.order,
                                  sim_arrays(free, paper_platform()).order)

    data = CompGraph("data")
    for i in range(2):
        data.add_op(f"w{i}", "Parameter", output_shape=(1, 8), bytes_out=64.0)
    la = build_chain_arrays(sim_arrays(data, paper_platform()))
    # no non-data node: one row of sentinels
    assert la.nodes.shape == (1, 1) and la.nodes[0, 0] == data.num_nodes

    for g in (free, data):
        placements = np.random.default_rng(0).integers(
            0, 2, (4, g.num_nodes)).astype(np.int32)
        _assert_matches_simulate_jax(g, paper_platform(), ref_paper(),
                                     placements)


def test_scan_backend_rejects_bad_placements_and_multi_graph_batches():
    g = make_diamond()
    backend = ScanBackend(device="cpu")
    prep = backend.prepare(g, paper_platform())
    with pytest.raises(ValueError, match="device ids"):
        backend.simulate_batch(prep, np.full((2, g.num_nodes), 2))
    with pytest.raises(ValueError, match="placements"):
        backend.simulate_batch(prep, np.zeros((2, g.num_nodes + 1), int))
    with pytest.raises(ValueError, match="unknown schedule"):
        backend.prepare(g, paper_platform(), schedule="nope")
    # Multi-graph batches, as the reference rejects them
    # (tests/test_multi_graph.py): a device id out of range at a real slot
    # raises, one at a pad slot is ignored, and a v_max below the largest
    # graph raises.
    small = random_dag(np.random.default_rng(5), 6, p=0.3)
    for b in (backend, LevelBackend(device="cpu")):
        preps = b.prepare_batch([small], paper_platform())
        with pytest.raises(ValueError, match="device ids"):
            b.simulate_multi(preps, np.full((1, 1, 6), 7))
        preps = b.prepare_batch([small], paper_platform(), v_max=10)
        p = np.zeros((1, 1, 10), int)
        p[0, 0, 6:] = 7
        assert np.isfinite(b.simulate_multi(preps, p).latency).all()
    for b in (backend, ReferenceBackend()):
        with pytest.raises(ValueError, match="v_max"):
            b.prepare_batch([g, small], paper_platform(), v_max=6)
        with pytest.raises(ValueError, match="at least one graph"):
            b.prepare_batch([], paper_platform())
