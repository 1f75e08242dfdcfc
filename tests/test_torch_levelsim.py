"""Port parity, ``level`` simulator: the plain makespan version against the
reference Pallas kernel (interpret mode), and the port's backend against the
reference f64 scheduler on the same level-major order."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core.costmodel import DeviceSpec as RefDeviceSpec  # noqa: E402
from repro.core.costmodel import Platform as RefPlatform  # noqa: E402
from repro.core.costmodel import paper_platform as ref_paper  # noqa: E402
from repro.core.costmodel import sim_arrays as ref_sim_arrays  # noqa: E402
from repro.graphs import PAPER_BENCHMARKS as REF_GRAPHS  # noqa: E402
from repro.kernels.levelsim import build_level_arrays as ref_levels  # noqa: E402
from repro.kernels.levelsim import level_makespan as ref_level_makespan  # noqa: E402

from repro_torch.core import DeviceSpec, Platform, paper_platform  # noqa: E402
from repro_torch.core.costmodel import sim_arrays  # noqa: E402
from repro_torch.core.sim import LevelBackend, get_backend  # noqa: E402
from repro_torch.kernels import (build_level_arrays, level_makespan,  # noqa: E402
                                 level_tensors)

from conftest import make_diamond, random_dag  # noqa: E402

RTOL = 1e-5     # the reference's own cross-backend tolerance (f32 vs f64)


def _graph(name):
    if name == "diamond":
        return make_diamond()
    if name == "random30":
        return random_dag(np.random.default_rng(3), 30)
    return REF_GRAPHS[name]()


def _four_devices(spec_cls, platform_cls):
    """A 4-device platform with non-uniform links, one per package."""
    devs = tuple(spec_cls(f"d{i}", "gpu", peak_flops=(1 + i) * 4e12,
                          mem_bw=(2 + i) * 1e11, dispatch_overhead=2e-6,
                          parallel_queues=1 + i % 3) for i in range(4))
    bw = np.full((4, 4), 20e9)
    bw[0, 1] = bw[1, 0] = 300e9
    np.fill_diagonal(bw, math.inf)
    lat = np.full((4, 4), 5e-6)
    np.fill_diagonal(lat, 0.0)
    return platform_cls(devs, bw, lat)


@pytest.mark.parametrize("name", ["diamond", "random30", "resnet50"])
def test_level_makespan_ref_matches_pallas_kernel(name):
    g = _graph(name)
    ref_sa = ref_sim_arrays(g, ref_paper(), schedule="level")
    placements = np.random.default_rng(0).integers(
        0, 2, (8, g.num_nodes)).astype(np.int32)
    want_f, want_t = ref_level_makespan(
        ref_levels(ref_sa), placements, ref_sa.queue_init, ref_sa.inv_bw,
        ref_sa.lat, interpret=True)

    sa = sim_arrays(g, paper_platform(), schedule="level")
    lt = level_tensors(build_level_arrays(sa), "cpu")
    launches = level_makespan.launches
    got_f, got_t = level_makespan(
        lt, torch.as_tensor(placements), torch.as_tensor(sa.queue_init),
        torch.as_tensor(sa.inv_bw), torch.as_tensor(sa.lat))
    assert level_makespan.launches == launches   # CPU tensors: plain version
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("name,devices", [
    ("diamond", 2), ("random30", 2), ("random30", 4),
    ("inception_v3", 2), ("resnet50", 2), ("bert_base", 2)])
def test_level_backend_matches_reference_scheduler(name, devices):
    g = _graph(name)
    if devices == 2:
        plat, ref_plat = paper_platform(), ref_paper()
    else:
        plat = _four_devices(DeviceSpec, Platform)
        ref_plat = _four_devices(RefDeviceSpec, RefPlatform)
    rng = np.random.default_rng(1)
    placements = rng.integers(0, devices, (6, g.num_nodes))
    placements[0] = 0
    backend = LevelBackend(device="cpu")
    prep = backend.prepare(g, plat)
    assert backend.prepare(g, plat) is prep          # cached per graph
    res = backend.simulate_batch(prep, placements)
    order = backend.schedule_order(prep)
    single = backend.simulate(prep, placements[-1])
    assert single.latency == res.latency[-1]
    for i, p in enumerate(placements):
        ref = ref_simulate(g, p, ref_plat, order=order)
        np.testing.assert_allclose(res.latency[i], ref.latency, rtol=RTOL)
        np.testing.assert_allclose(res.reward[i], ref.reward, rtol=RTOL)
        np.testing.assert_allclose(res.transfer_time[i], ref.transfer_time,
                                   rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(res.per_device_busy[i],
                                   ref.per_device_busy, rtol=RTOL)
        assert bool(res.oom[i]) == ref.oom


def test_level_backend_scores_oom_as_zero_reward():
    g = make_diamond()
    devs = (DeviceSpec("small", "gpu", peak_flops=1e12, mem_bw=1e11,
                       dispatch_overhead=1e-6, mem_capacity=100.0),
            DeviceSpec("big", "cpu", peak_flops=1e12, mem_bw=1e11,
                       dispatch_overhead=1e-6))
    bw = np.array([[math.inf, 1e10], [1e10, math.inf]])
    plat = Platform(devs, bw, np.array([[0.0, 1e-6], [1e-6, 0.0]]))
    backend = get_backend("level", device="cpu")
    res = backend.simulate_batch(backend.prepare(g, plat),
                                 np.stack([np.zeros(7, int), np.ones(7, int)]))
    assert res.oom.tolist() == [True, False]
    assert res.reward[0] == 0.0 and res.reward[1] > 0.0


def test_level_backend_rejects_bad_placements():
    g = make_diamond()
    backend = LevelBackend(device="cpu")
    prep = backend.prepare(g, paper_platform())
    with pytest.raises(ValueError, match="device ids"):
        backend.simulate_batch(prep, np.full((2, g.num_nodes), 7))
    with pytest.raises(ValueError, match="device ids"):
        backend.simulate_batch(prep, np.full((2, g.num_nodes), -1))
    with pytest.raises(ValueError, match="placements"):
        backend.simulate_batch(prep, np.zeros((2, g.num_nodes + 1), int))
    with pytest.raises(ValueError, match="unknown simulator backend"):
        get_backend("scan", device="cpu")


def test_entry_points_need_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        assert LevelBackend().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LevelBackend()
