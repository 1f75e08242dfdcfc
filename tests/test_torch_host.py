"""Port parity, host layer: graphs, features, cost model and level tables.

The port copies the reference's numpy host code (it may not import it: the
reference package imports JAX), so every host array must be bitwise equal.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.costmodel import sim_arrays as ref_sim_arrays  # noqa: E402
from repro.core.features import batch_graph_arrays as ref_batch  # noqa: E402
from repro.core.features import extract_features as ref_features  # noqa: E402
from repro.core.graph import topological_order as ref_topo  # noqa: E402
from repro.graphs import PAPER_BENCHMARKS as REF_GRAPHS  # noqa: E402
from repro.kernels.levelsim import build_level_arrays as ref_levels  # noqa: E402
from repro.core import paper_platform as ref_platform  # noqa: E402

from repro_torch.core import (batch_graph_arrays, extract_features,  # noqa: E402
                              paper_platform, sim_arrays, simulate,
                              topological_order)
from repro_torch.graphs import PAPER_BENCHMARKS  # noqa: E402
from repro_torch.kernels import build_level_arrays  # noqa: E402

from test_golden_latency import GOLDEN, RTOL  # noqa: E402

NAMES = sorted(PAPER_BENCHMARKS)


def _assert_fields_equal(mine, ref, fields):
    for f in fields:
        a, b = getattr(mine, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("name", NAMES)
def test_host_arrays_bitwise_equal(name):
    g, rg = PAPER_BENCHMARKS[name](), REF_GRAPHS[name]()
    np.testing.assert_array_equal(g.edges, rg.edges)
    assert [dataclasses.astuple(n) for n in g.nodes] == \
        [dataclasses.astuple(n) for n in rg.nodes]
    np.testing.assert_array_equal(topological_order(g), ref_topo(rg))

    arrays, ref_arrays = extract_features(g), ref_features(rg)
    _assert_fields_equal(arrays, ref_arrays,
                         ["x", "adj", "edges", "topo_pos", "flops",
                          "bytes_out", "op_type_ids", "feature_slices"])
    _assert_fields_equal(batch_graph_arrays([arrays]), ref_batch([ref_arrays]),
                         ["x", "adj", "edges", "node_mask", "edge_mask",
                          "num_nodes", "num_edges"])

    for schedule in ("topo", "level"):
        sa = sim_arrays(g, paper_platform(), schedule=schedule)
        ref_sa = ref_sim_arrays(rg, ref_platform(), schedule=schedule)
        _assert_fields_equal(sa, ref_sa, type(ref_sa)._fields)
    _assert_fields_equal(build_level_arrays(sa), ref_levels(ref_sa),
                         ["nodes", "preds", "dur", "pred_bytes", "pred_data",
                          "order"])


@pytest.mark.parametrize("name", NAMES)
def test_simulate_reproduces_golden(name):
    g = PAPER_BENCHMARKS[name]()
    gold = GOLDEN[name]
    assert (g.num_nodes, g.num_edges) == (gold["num_nodes"],
                                          gold["num_edges"])
    plat = paper_platform()
    cpu = simulate(g, np.zeros(g.num_nodes, np.int64), plat).latency
    gpu = simulate(g, np.ones(g.num_nodes, np.int64), plat).latency
    np.testing.assert_allclose(cpu, gold["cpu_only"], rtol=RTOL)
    np.testing.assert_allclose(gpu, gold["gpu_only"], rtol=RTOL)


def test_port_imports_without_jax():
    """The port and every module of it import with JAX blocked, and load
    nothing of the reference package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "import repro_torch.models, repro_torch.configs\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.graphs.workloads, repro_torch.core.planner\n"
        "import repro_torch.core.train.sampler\n"
        "import repro_torch.core.train.curriculum\n"
        "import repro_torch.configs.qwen1_5_0_5b\n"
        "from repro_torch.core.train import CurriculumTrainer\n"
        "import repro_torch.core.baselines, repro_torch.core.executor\n"
        "import repro_torch.graphs.traced, repro_torch.api\n"
        "assert repro_torch.PlacementSession.__module__ =="
        " 'repro_torch.api.session'\n"
        "assert repro_torch.configs.all_archs() == ("
        "'command-r-plus-104b', 'h2o-danube-1.8b', 'internvl2-76b', "
        "'jamba-1.5-large-398b', 'mamba2-130m', 'mixtral-8x22b', "
        "'musicgen-medium', 'olmoe-1b-7b', 'phi3-mini-3.8b', "
        "'qwen1.5-0.5b')\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
