"""Port parity and checks, the dry run (``repro_torch/launch/dryrun.py``,
``launch/perf.py``, ``launch/mesh.py``) and the model's sharding under a
mesh (``shard()`` at the reference's sites, ``kernels/_dtensor.py``,
``data/pipeline.py``'s per-rank rows, ``launch/train.place_state``).

* ``_rules_for`` and ``VARIANTS`` equal the reference's (but its
  ``qchunk_*``, which set a field the port refuses), read in one
  subprocess: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512
  host devices, which must not reach this process's JAX.  Importing the
  port's dry run, in the same subprocess before, sets no environment
  variable at all.
* A smoke config's train, prefill and decode steps counted on fake tensors
  on a fake (2, 2) mesh equal the same steps counted on real CPU tensors
  (the kernels' counted route), exactly: FLOPs, bytes, each kernel's calls
  and work, the collectives, the placed argument bytes and the peak of
  live bytes.  So do danube's decode steps, whose KV heads are replicated
  and whose cache slots split over "model" (with and without the cap).
* ``memory_tracker`` counts by hand-worked bytes: a view and an in-place
  op add nothing, a freed intermediate leaves the count, and a DTensor
  redistribute on a fake (2, 2) mesh counts the collective's output (and
  a reshuffle's) but not DTensor's global-shape stand-ins, the same on
  fake and on real tensors.
* A production-mesh cell carries the reference's record keys, with
  nonzero FLOPs, bytes and memory.  A batch its mesh axes do not divide is
  padded to their multiple, as GSPMD pads, and the record says so.
* On a 1×2 gloo mesh (two processes), danube's SMOKE train step with
  ``shard()`` active (query heads split, KV heads replicated: each rank
  reads the KV heads of its own query heads) is within 1e-5 of the
  unsharded step: loss, every gradient and the updated parameters; so is
  ``flash_attention`` on DTensors whose KV heads divide the mesh dim (kept
  with their query groups) and on ones whose single KV head does not
  (gathered), output and gradients.  The
  pipeline's rows made per rank on a 2-way "data" mesh are the reference's
  global batch rows, bit for bit.  The same ranks run danube's SMOKE decode
  step through ``decode_attention_local`` in both decode layouts (KV heads
  split; cache slots split, with and without the cap), within 1e-5 of the
  unsharded step.
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
#: decode under a mesh, as ``_rules_for`` lays it out (rules, softcap): KV
#: heads sharded over "model" with their query groups, or replicated with
#: the cache's sequence sharded over "model" instead (danube's decode
#: cells), with and without a cap that bites on the SMOKE scores
DECODE_LAYOUTS = {
    "kv_heads": ({"kv_heads": "model"}, 0.0),
    "cache_seq": ({"kv_heads": None, "cache_seq": "model"}, 0.0),
    "cache_seq_capped": ({"kv_heads": None, "cache_seq": "model"}, 1.0)}


@pytest.fixture(scope="module")
def fresh_process():
    """One fresh process: the environment and the default process group
    after importing the port's dry-run modules, then the reference's
    ``_rules_for`` of every cell and its ``VARIANTS`` (importing
    ``repro.launch.dryrun`` sets ``XLA_FLAGS``, which must not reach this
    process's JAX)."""
    code = textwrap.dedent("""
        import json, os
        before = dict(os.environ)
        import repro_torch.launch.dryrun, repro_torch.launch.perf
        import repro_torch.launch.mesh, repro_torch.launch.report
        import torch.distributed as d
        port = [dict(os.environ) == before, d.is_initialized()]
        from repro.configs import SHAPES, all_archs
        from repro.launch import dryrun, perf
        rules = {f"{a}|{s}|{m}": dryrun._rules_for(a, s, m)
                 for a in all_archs() for s in SHAPES for m in (False, True)}
        print(json.dumps({"port": port, "rules": rules,
                          "variants": perf.VARIANTS}))
    """)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _jsonable(x):
    return json.loads(json.dumps(x))


def test_rules_and_variants_are_the_references(fresh_process):
    want = fresh_process
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


def test_importing_the_dry_run_sets_no_environment_variable(fresh_process):
    assert fresh_process["port"] == [True, False]


def _counts(rec):
    return {"flops": rec["flops"], "bytes": rec["bytes_accessed"],
            "kernels": rec["kernels"], "collectives": rec["collectives"],
            "args": rec["memory"]["argument_size_in_bytes"],
            "peak": rec["memory"]["peak_bytes"],
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
        assert got["peak"] > got["args"], (arch, kind)
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
    decode = {name: _sharded_decode(mesh, rules, cap)
              for name, (rules, cap) in DECODE_LAYOUTS.items()}
    return {"loss": [float(met_u["loss"]), float(full(met_s["loss"]))],
            "grads": diff(grads[1], grads[0]),
            "params": diff(new_s.params, new_u.params),
            "dtensor_grads": all(isinstance(g, DTensor)
                                 for g in tree_leaves(grads[1])),
            "wq": heads,
            "rows": {k: v.to_local().tolist() for k, v in rows.items()},
            "attention": _sharded_heads_attention(mesh),
            "decode": decode}


def _sharded_decode(mesh, rules, cap):
    """danube's SMOKE decode step (a 12-token prefill into a ring of 8
    slots, then position 12) unsharded and on ``mesh`` under ``rules``
    (parameters and caches placed by their logical axes), with logit
    softcap ``cap`` → the largest logit difference, how far the uncapped
    step's logits lie from the capped ones, and the layout each rank's
    ``decode_attention_local`` saw (placements of the cache's K)."""
    import copy
    import dataclasses

    from repro_torch.configs.registry import cache_axes_for
    from repro_torch.distributed.sharding import (
        _map_axes, distribute_tree, logical_spec, param_specs,
        placements_for, use_rules, with_rules)
    from repro_torch.kernels import _dtensor
    from repro_torch.models import decode_step, init_params, param_axes
    from repro_torch.models import prefill
    cfg = dataclasses.replace(get(STEP_ARCH).smoke_config,
                              attn_logit_softcap=cap)
    gen = torch.Generator().manual_seed(7)
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
    _, caches = prefill(params, cfg, tokens, max_len=16)
    want, _ = decode_step(params, cfg, nxt, copy.deepcopy(caches), 12)
    plain, _ = decode_step(params, dataclasses.replace(
        cfg, attn_logit_softcap=0.0), nxt, copy.deepcopy(caches), 12)
    full_rules = with_rules(rules)
    cspec = _map_axes(lambda axes: placements_for(
        logical_spec(axes, full_rules, mesh), mesh), cache_axes_for(cfg))
    seen = []
    inner = _dtensor.decode_attention_local

    def spy(q, k, *a, **kw):
        seen.append([getattr(p, "dim", None) for p in k.placements])
        return inner(q, k, *a, **kw)
    _dtensor.decode_attention_local = spy
    try:
        with use_rules(mesh, rules):
            got, _ = decode_step(
                distribute_tree(params, param_specs(param_axes(cfg), mesh,
                                                    rules), mesh),
                cfg, nxt, distribute_tree(caches, cspec, mesh), 12)
    finally:
        _dtensor.decode_attention_local = inner
    return {"diff": float((got.full_tensor() - want).abs().max()),
            "cap_moves": float((plain - want).abs().max()),
            "layouts": seen}


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


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two gloo ranks running ``_rank_step``."""
    return spawn_ranks("test_torch_dryrun", "_rank_step", 2,
                       tmp_path_factory.mktemp("ranks"), timeout=240)


def test_two_gloo_ranks_train_step_and_pipeline_rows(two_ranks):
    from repro.data.pipeline import DataConfig as RefDataConfig
    from repro.data.pipeline import SyntheticTokens as RefTokens
    results = two_ranks
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


@pytest.mark.parametrize("layout", list(DECODE_LAYOUTS))
def test_sharded_decode_equals_the_unsharded_step(two_ranks, layout):
    """danube's SMOKE decode step on the 1x2 gloo mesh through
    ``decode_attention_local`` against the unsharded step, 1e-5: its KV
    heads split with their query groups, or its cache's slots split, the
    ranks' partial softmaxes combined by all-reduces (with the cap too)."""
    # the cache's K as attention reads it, (B, W, KV, Dh): batch over
    # "data", KV heads (dim 2) or slots (dim 1) over "model"
    split = {"kv_heads": 2, "cache_seq": 1, "cache_seq_capped": 1}[layout]
    for res in two_ranks:
        got = res["decode"][layout]
        assert got["diff"] <= TOL, got
        assert got["layouts"] == [[0, split]] * 2     # both layers
        if DECODE_LAYOUTS[layout][1]:
            assert got["cap_moves"] > 10 * TOL, got


@pytest.mark.parametrize("cap", [0.0, 1.0])
def test_decode_fake_counts_equal_the_real_cpu_counts_seq_split(cap):
    """danube's SMOKE decode cell, whose KV heads are replicated and whose
    cache slots split over "model" (``_rules_for``'s decode rule), on a
    fake (2, 2) mesh: fake counts equal the real CPU counts, and (uncapped)
    the partial softmaxes combine by two all-reduces a layer more than
    with the slots whole."""
    arch = "h2o-danube-1.8b"
    cfg = get(arch).smoke_config
    shp = ShapeSpec("smoke_decode", "decode", 32, 4)
    assert dryrun._rules_for(arch, shp, False)["cache_seq"] == "model"
    runs = [dryrun.run_cell(arch, shp, mesh_shape=(2, 2), config=cfg,
                            config_overrides={"attn_logit_softcap": cap},
                            real=real) for real in (False, True)]
    assert _counts(runs[0]) == _counts(runs[1])
    if cap:
        return
    unsplit = dryrun.run_cell(arch, shp, mesh_shape=(2, 2), config=cfg,
                              extra_rules={"cache_seq": None})
    added = (runs[0]["collectives"]["counts"]["all-reduce"]
             - unsplit["collectives"]["counts"]["all-reduce"])
    assert added == 2 * cfg.n_layers


def test_a_batch_its_axes_do_not_divide_is_padded():
    """qwen1.5-0.5b's SMOKE prefill at batch 4 on a fake (2, 4, 2)
    ("pod", "data", "model") mesh, whose batch axes make 8 shards: the
    step runs on a batch of 8, as GSPMD pads, the record names it and keeps
    the real tokens; its counts are those of a batch of 8."""
    arch = "qwen1.5-0.5b"
    cfg = get(arch).smoke_config
    recs = [dryrun.run_cell(arch, ShapeSpec("smoke_prefill", "prefill", 32,
                                            b), multi_pod=True,
                            mesh_shape=(2, 4, 2), config=cfg)
            for b in (4, 8)]
    assert recs[0]["padded_batch"] == 8 and "padded_batch" not in recs[1]
    assert (recs[0]["tokens"], recs[1]["tokens"]) == (4 * 32, 8 * 32)
    assert _counts(recs[0]) == _counts(recs[1])


# ------------------------------------------------------- memory_tracker
def _empty(mode, shape):
    """A (4, 4)-like f32 tensor: fake under ``mode``, else real."""
    if mode is None:
        return torch.randn(shape)
    with mode:
        return torch.empty(shape)


@pytest.mark.parametrize("fake", [True, False])
def test_memory_tracker_counts_views_in_place_and_frees(fake):
    """A tracked 4x4 f32 argument (64 B); a view of it and an in-place op
    on it add nothing; ``a = x * 2`` adds 64, ``b = a + 1`` 64 more (the
    peak, 192), freeing ``a`` takes 64 off, ``b.sum()`` adds its 4-byte
    scalar, freeing ``b`` takes 64 off."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode() if fake else None
    x = _empty(mode, (4, 4))
    mem = dryrun.memory_tracker(mode)
    mem.track([x])
    live = [mem.live]
    with mem:
        y = x.view(16)
        live.append(mem.live)
        x.add_(1)
        live.append(mem.live)
        a = x * 2
        live.append(mem.live)
        b = a + 1
        live.append(mem.live)
        del a
        live.append(mem.live)
        c = b.sum()
        live.append(mem.live)
        del b
        live.append(mem.live)
    assert live == [64, 64, 64, 128, 192, 128, 132, 68]
    assert mem.peak == 192
    assert y.shape == (16,) and c.shape == ()


@pytest.mark.parametrize("fake", [True, False])
def test_memory_tracker_counts_a_redistribute_on_a_fake_mesh(fake):
    """Rank 0 of a fake (2, 2) mesh: a DTensor whose 4x4 f32 local shard
    (64 B) splits a dim over "data".  Gathering it whole allocates the
    all-gather's 8x4 output (128 B); over dim 0 that is the result (peak
    64 + 128), over dim 1 the gathered rows are reshuffled into a fresh
    4x8 (peak 64 + 128 + 128, the gathered buffer then freed).  ``x * 2``
    on the shard adds its 64-B local result alone: sharding propagation's
    global-shape stand-ins are not counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    got = {}
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else None
        for dim, whole in ((0, (8, 4)), (1, (4, 8))):
            x = DTensor.from_local(_empty(mode, (4, 4)), mesh,
                                   [Shard(dim), Replicate()],
                                   run_check=False, shape=torch.Size(whole),
                                   stride=(whole[1], 1))
            mem = dryrun.memory_tracker(mode)
            mem.track([x])
            with mem:
                y = x.redistribute(mesh, [Replicate(), Replicate()])
                gathered = (mem.live, mem.peak)
                z = x * 2
            assert y.to_local().shape == whole
            assert z.to_local().shape == (4, 4)
            got[dim] = gathered + (mem.live,)
    assert got == {0: (192, 192, 256), 1: (192, 320, 256)}


@pytest.mark.parametrize("fake", [True, False])
def test_counting_routes_free_what_the_kernels_free(fake):
    """The kernels' counting routes (fake tensors, or real CPU ones while
    the work counter runs) keep alive only what the kernels' autograd
    Functions save: under remat (``torch.utils.checkpoint``, whose hooks
    drop saved tensors) flash_attention's q and k and rmsnorm's input are
    freed after the forward, and ssd_scan's input dbx is freed without
    remat (``SSDScanFn`` saves the decay and h_before only)."""
    import gc
    import weakref

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    from repro_torch.kernels._work import COUNTER
    mode = FakeTensorMode() if fake else None
    a = _empty(mode, (2, 4, 16, 8)).requires_grad_(True)
    scale = _empty(mode, (8,))
    decay = _empty(mode, (2, 3, 4))
    refs = []

    def block(t):
        q, k = t * 2, t[:, :1] * 3
        x = t + 1
        refs.extend(weakref.ref(u) for u in (q, k, x))
        return flash_attention(q, k, k * 1, causal=True) + rmsnorm(x, scale)

    def scan(t):
        dbx = t.reshape(2, 4, 4, 4, 8)[:, :3] * 2
        refs.append(weakref.ref(dbx))
        return ssd_scan(decay, dbx)

    with COUNTER.counting():
        y = checkpoint(block, a, use_reentrant=False)
        before, final = scan(a)
        gc.collect()
        assert [r() is None for r in refs] == [True] * 4
        (y.sum() + before.sum() + final.sum()).backward()
    assert a.grad.shape == a.shape
    assert set(COUNTER.calls) == {"flash_attention", "flash_attention_bwd",
                                  "rmsnorm", "rmsnorm_bwd", "ssd_scan",
                                  "ssd_scan_bwd"}
