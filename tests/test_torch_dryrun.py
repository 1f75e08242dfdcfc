"""Port parity and checks, the dry run (``repro_torch/launch/dryrun.py``,
``launch/perf.py``, ``launch/mesh.py``) and the model's sharding under a
mesh (``shard()`` at the reference's sites, ``kernels/_dtensor.py``,
``data/pipeline.py``'s per-rank rows, ``launch/train.place_state``).

* ``_rules_for`` and ``VARIANTS`` equal the reference's (but its
  ``qchunk_*``, which set a field the port refuses), read in one
  subprocess: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512
  host devices, which must not reach this process's JAX.  Importing the
  port's dry run sets no environment variable at all.
* A smoke config's train, prefill and decode steps counted on fake tensors
  on a fake (2, 2) mesh equal the same steps counted on real CPU tensors
  (the kernels' counted route), exactly: FLOPs, bytes, each kernel's calls
  and work, the collectives and the placed argument bytes.  On the GQA
  path whose KV heads a rank slices (danube's train step), the fake run's
  autograd copies two K/V gradients more in a view's backward
  (``ViewBackward0``'s reshape): its bytes are held to 0.5 % there, the
  rest exactly.
* A production-mesh cell carries the reference's record keys, with
  nonzero FLOPs, bytes and memory.
* On a 1×2 gloo mesh (two processes), danube's SMOKE train step with
  ``shard()`` active (query heads split, KV heads replicated: each rank
  reads the KV heads of its own query heads) is within 1e-5 of the
  unsharded step: loss, every gradient and the updated parameters; so is
  ``flash_attention`` on DTensors whose KV heads divide the mesh dim (kept
  with their query groups) and on ones whose single KV head does not
  (gathered), output and gradients.  The
  pipeline's rows made per rank on a 2-way "data" mesh are the reference's
  global batch rows, bit for bit.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, ShapeSpec, all_archs, get  # noqa: E402
from repro_torch.launch import dryrun, perf  # noqa: E402
from repro_torch.launch.mesh import production_shape  # noqa: E402
from repro_torch.models.config import UNREAD  # noqa: E402

from test_torch_distributed import SRC, spawn_ranks  # noqa: E402

#: the reference's record keys (``src/repro/launch/dryrun.py:170-256``)
#: that a traced cell carries; its R1/R2 extrapolation's ``cost_samples``
#: has no counterpart (every layer is traced)
REF_KEYS = {"arch", "shape", "mesh", "num_devices", "params",
            "active_params", "rules", "compile_scanned_s", "memory",
            "flops", "bytes_accessed", "collectives", "cost_source",
            "total_s"}
STEP_ARCH, STEP_B, STEP_S = "h2o-danube-1.8b", 4, 32
TOL = 1e-5


def _ref_subprocess(code: str):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _jsonable(x):
    return json.loads(json.dumps(x))


def test_rules_and_variants_are_the_references():
    want = _ref_subprocess("""
        import json
        from repro.configs import SHAPES, all_archs
        from repro.launch import dryrun, perf
        rules = {f"{a}|{s}|{m}": dryrun._rules_for(a, s, m)
                 for a in all_archs() for s in SHAPES for m in (False, True)}
        print(json.dumps({"rules": rules, "variants": perf.VARIANTS}))
    """)
    got = {f"{a}|{s}|{m}": dryrun._rules_for(a, s, m)
           for a in all_archs() for s in SHAPES for m in (False, True)}
    assert _jsonable(got) == want["rules"]
    # the reference's variants but those that set a field the port refuses
    # (``models/config.UNREAD``: it has no query chunk)
    keep = {k: v for k, v in want["variants"].items()
            if not set(v[1]) & set(UNREAD)}
    assert set(want["variants"]) - set(keep) == {"qchunk_512", "qchunk_4096"}
    assert _jsonable(perf.VARIANTS) == keep
    assert production_shape() == ((32, 8), ("data", "model"))
    assert production_shape(True) == ((2, 32, 8), ("pod", "data", "model"))


def test_importing_the_dry_run_sets_no_environment_variable():
    code = ("import os, json; before = dict(os.environ); "
            "import repro_torch.launch.dryrun, repro_torch.launch.perf, "
            "repro_torch.launch.mesh, repro_torch.launch.report; "
            "import torch.distributed as d; "
            "print(json.dumps([dict(os.environ) == before, "
            "d.is_initialized()]))")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, False]


def _counts(rec):
    return {"flops": rec["flops"], "bytes": rec["bytes_accessed"],
            "kernels": rec["kernels"], "collectives": rec["collectives"],
            "args": rec["memory"]["argument_size_in_bytes"],
            "state": rec.get("state_bytes")}


@pytest.mark.parametrize("arch,kinds", [
    ("qwen1.5-0.5b", ("train", "prefill", "decode")),
    ("olmoe-1b-7b", ("train",)),
    ("mamba2-130m", ("train",)),
    ("h2o-danube-1.8b", ("train",))])
def test_fake_counts_equal_the_real_cpu_counts(arch, kinds):
    cfg = get(arch).smoke_config
    for kind in kinds:
        shp = ShapeSpec(f"smoke_{kind}", kind, 32, 4)
        fake = dryrun.run_cell(arch, shp, mesh_shape=(2, 2), config=cfg)
        real = dryrun.run_cell(arch, shp, mesh_shape=(2, 2), config=cfg,
                               real=True)
        got, want = _counts(fake), _counts(real)
        assert got["flops"] > 0 and got["kernels"], (arch, kind)
        assert set(got["kernels"]) >= {"rmsnorm"}
        if arch == "h2o-danube-1.8b" and kind == "train":
            assert 0 <= got.pop("bytes") - want.pop("bytes") <= \
                0.005 * real["bytes_accessed"]
        assert got == want, (arch, kind)
        assert fake["cost_source"] == "traced, every layer"
        if kind == "decode":
            assert fake["tokens"] == 4


def test_int8_fake_counts_equal_the_real_cpu_counts():
    """jamba's SMOKE prefill with int8 weights (``quantize_weights``: the
    dry run's tree from ``abstract_quantized``, laid out by
    ``quantize_spec_tree``): its SSD, MoE and attention layers."""
    arch = "jamba-1.5-large-398b"
    shp = ShapeSpec("smoke_prefill", "prefill", 32, 4)
    runs = [dryrun.run_cell(arch, shp, mesh_shape=(2, 2),
                            config=get(arch).smoke_config,
                            config_overrides={"quantize_weights": True},
                            real=real) for real in (False, True)]
    assert _counts(runs[0]) == _counts(runs[1])
    assert set(runs[0]["kernels"]) == {"rmsnorm", "ssd_scan",
                                       "flash_attention"}


def test_a_production_mesh_cell_has_the_references_record():
    """mamba2-130m's SMOKE config at the decode_32k shape on the (32, 8)
    fake mesh, as ``main`` writes it."""
    import dataclasses
    cfg = get("mamba2-130m").smoke_config
    rec = dryrun.run_cell("mamba2-130m", dataclasses.replace(
        SHAPES["decode_32k"], seq_len=512), config=cfg)
    assert REF_KEYS <= set(rec)
    assert rec["mesh"] == "32x8" and rec["num_devices"] == 256
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["peak_bytes"] >= \
        rec["memory"]["argument_size_in_bytes"]
    assert set(rec["collectives"]) >= {"all-reduce", "all-gather", "total",
                                       "counts", "by_axis"}
    skipped = dryrun.run_cell("qwen1.5-0.5b", "long_500k")
    assert skipped == {"arch": "qwen1.5-0.5b", "shape": "long_500k",
                       "skipped": get("qwen1.5-0.5b").skip["long_500k"]}


# ------------------------------------------------- two gloo ranks, 1x2
def _rank_step(rank, world, out_dir):
    """One rank: danube's SMOKE train step unsharded and on a (1, 2) mesh
    under ``use_rules``; then the pipeline's rows on a 2-way data mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.train import place_state
    from repro_torch.models import TrainState, init_params, make_train_step
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import GradientTransform, adamw
    cfg = get(STEP_ARCH).smoke_config
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    rules = dryrun._rules_for(STEP_ARCH, ShapeSpec("t", "train", STEP_S,
                                                   STEP_B), False)
    opt = adamw(1e-3)
    grads = []

    def update(g, state, params=None):
        grads.append(g)
        return opt.update(g, state, params)
    step = make_train_step(cfg, GradientTransform(opt.init, update))
    params = init_params(cfg, seed=0, device="cpu")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=STEP_S,
                      global_batch=STEP_B, seed=5)
    new_u, met_u = step(state, SyntheticTokens(data, "cpu").batch(0))
    placed = place_state(state, cfg, mesh, rules)
    with use_rules(mesh, rules):
        new_s, met_s = step(placed, SyntheticTokens(data, "cpu",
                                                    mesh=mesh).batch(0))
    full = (lambda t: t.full_tensor() if isinstance(t, DTensor) else t)

    def diff(a, b):
        return max(float((full(x) - y).abs().max()) for x, y in
                   zip(tree_leaves(a), tree_leaves(b)))
    heads = [getattr(p, "dim", None)
             for p in placed.params["blocks"][0]["mixer"]["wq"].placements]
    mesh_d = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    rows = SyntheticTokens(data, "cpu", mesh=mesh_d).batch(3)
    return {"loss": [float(met_u["loss"]), float(full(met_s["loss"]))],
            "grads": diff(grads[1], grads[0]),
            "params": diff(new_s.params, new_u.params),
            "dtensor_grads": all(isinstance(g, DTensor)
                                 for g in tree_leaves(grads[1])),
            "wq": heads,
            "rows": {k: v.to_local().tolist() for k, v in rows.items()},
            "attention": _sharded_heads_attention(mesh)}


def _sharded_heads_attention(mesh):
    """``flash_attention`` on DTensors whose 4 query heads are split over
    the mesh's "model" dim (2) and whose KV heads are replicated, against
    the plain call on whole tensors: with 2 KV heads each rank keeps its
    query group's KV head; with 1, its one query group would split over
    the 2 ranks, so the heads are gathered.  The largest output and
    gradient differences, and the layout the output came back in."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import flash_attention
    gen = torch.Generator().manual_seed(3)
    out = {}
    for kv in (2, 1):
        whole = [torch.randn(2, h, 16, 8, generator=gen)
                 for h in (4, kv, kv)]
        w = torch.randn(2, 4, 16, 8, generator=gen)
        plain = [t.clone().requires_grad_(True) for t in whole]
        y = flash_attention(*plain, causal=True)
        gp = torch.autograd.grad((y * w).sum(), plain)
        dts = [distribute_tensor(t, mesh, [Replicate(), p]).requires_grad_(
            True) for t, p in zip(whole, (Shard(1), Replicate(),
                                          Replicate()))]
        ys = flash_attention(*dts, causal=True)
        gs = torch.autograd.grad((ys * distribute_tensor(
            w, mesh, list(ys.placements))).sum(), dts)
        out[kv] = {"out": float((ys.full_tensor() - y).abs().max()),
                   "grads": max(float((a.full_tensor() - b).abs().max())
                                for a, b in zip(gs, gp)),
                   "heads": [getattr(p, "dim", None)
                             for p in ys.placements]}
    return out


def test_two_gloo_ranks_train_step_and_pipeline_rows(tmp_path):
    from repro.data.pipeline import DataConfig as RefDataConfig
    from repro.data.pipeline import SyntheticTokens as RefTokens
    results = spawn_ranks("test_torch_dryrun", "_rank_step", 2, tmp_path,
                          timeout=240)
    cfg = get(STEP_ARCH).smoke_config
    ref = RefTokens(RefDataConfig(vocab_size=cfg.vocab_size, seq_len=STEP_S,
                                  global_batch=STEP_B, seed=5)).batch(3)
    half = STEP_B // 2
    for rank, res in enumerate(results):
        loss_u, loss_s = res["loss"]
        assert abs(loss_s - loss_u) <= TOL * abs(loss_u)
        assert res["grads"] <= TOL and res["params"] <= TOL, res
        assert res["dtensor_grads"]
        # query heads split over "model", the KV heads replicated (rules)
        assert res["wq"] == [None, 2]
        for key in ("tokens", "labels"):
            want = np.asarray(ref[key])[rank * half:(rank + 1) * half]
            assert np.array_equal(np.asarray(res["rows"][key]), want), key
    assert results[0]["loss"] == results[1]["loss"]
    for res in results:
        att = res["attention"]
        assert att["2"]["heads"] == [None, 1]    # KV heads with their groups
        assert att["1"]["heads"] == [None, None]  # a group split: gathered
        for kv in ("2", "1"):
            assert att[kv]["out"] <= TOL and att[kv]["grads"] <= TOL, att
