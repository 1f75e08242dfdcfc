"""Port parity, the LM training slice: the optimizer pieces (schedules,
clipping, AdamW and its moments' dtypes), ``cross_entropy``, one
``make_train_step`` on every SMOKE config against ``jax.value_and_grad`` of
the reference's loss, three steps, grad accumulation and remat on
danube-smoke and mamba2-smoke against the reference's train step, the plain
kernels' vjps against ``jax.vjp`` of ``repro/kernels/ref.py``, the backward
kernels' launch plans, ``TrainState`` checkpoints across the two packages
and the ``launch.train`` entry point.

Weights are the reference's ``init_params`` carried across with
``lm_params_from_numpy``; batches are made with numpy from a seed and handed
to both.  Tolerances (float32 throughout unless stated):

* schedules: 1 ulp of float32 (``cos`` and ``pow`` may round differently);
* the loss within 1e-5 relative and every gradient leaf within 1e-4 of the
  leaf's largest entry (``GRAD_TOL``): sums run in another order across the
  frameworks, and a leaf's small entries carry the rounding of its large
  ones;
* parameters after AdamW steps within 1e-5 of the leaf's largest entry:
  Adam's first steps divide each gradient by its own magnitude, so a
  gradient entry's rounding moves its update by at most its relative error;
* bf16 values within one bf16 ulp where the reference rounds a float32
  product that differs from the port's in its last bit.
"""
import dataclasses
import functools
import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.configs import get as ref_get  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro.models import TrainState as RefTrainState  # noqa: E402
from repro.models import cross_entropy as ref_cross_entropy  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import make_train_step as ref_make_train_step  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    lm_params_from_numpy,
                                    lm_train_state_from_numpy)
from repro_torch.configs import get  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import (TrainState, cross_entropy,  # noqa: E402
                                forward, make_train_step)
from repro_torch.models.lm import _value_and_grad  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402

# the package exports the wrappers under the modules' names
flash_mod = importlib.import_module("repro_torch.kernels.flash_attention")
rms_mod = importlib.import_module("repro_torch.kernels.rmsnorm")
ssd_mod = importlib.import_module("repro_torch.kernels.ssd_scan")

ARCHS = ["command-r-plus-104b", "h2o-danube-1.8b", "internvl2-76b",
         "jamba-1.5-large-398b", "mamba2-130m", "mixtral-8x22b",
         "musicgen-medium", "olmoe-1b-7b", "phi3-mini-3.8b", "qwen1.5-0.5b"]
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
LOSS_RTOL = 1e-5
BATCH, SEQ, CHUNK = 2, 12, 4
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy() \
        if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _batch(cfg, seed=1, b=BATCH, s=SEQ):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())})


@functools.lru_cache(maxsize=None)
def _ref_init(ref_cfg):
    """The reference's initial weights (immutable arrays, so one draw
    serves every test of a config)."""
    return ref_init_params(ref_cfg, jax.random.PRNGKey(0))


def _models(arch, **replace):
    ref_cfg = dataclasses.replace(ref_get(arch).smoke_config, **replace)
    cfg = dataclasses.replace(get(arch).smoke_config, **replace)
    ref_params = _ref_init(ref_cfg)
    tree = jax.tree.map(np.asarray, ref_params)
    return ref_cfg, ref_params, cfg, lm_params_from_numpy(tree, cfg, "cpu")


def _assert_trees_close(got_tree, want_tree, tol, what):
    got, want = tree_leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(np.shape(w)), (what, i)
        err = _normwise(_np(g), np.asarray(w, np.float32))
        assert err <= tol, (what, i, tuple(g.shape), err)


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("cosine_decay", (3e-4, 40, 0.1)),
    ("linear_warmup_cosine", (3e-4, 10, 50)),
    ("linear_warmup_cosine", (3e-4, 10, 100)),
    ("linear_warmup_cosine", (1e-3, 0, 7))])
def test_schedules_match_the_reference_to_one_ulp(name, args):
    want_fn = getattr(ref_optim, name)(*args)
    got_fn = getattr(optim, name)(*args)
    for step in range(51):
        want = np.float32(want_fn(jnp.int32(step)))
        got = got_fn(torch.tensor(step) if step % 2 else step)
        assert isinstance(got, np.float32), type(got)
        ulps = abs(int(got.view(np.int32)) - int(want.view(np.int32)))
        assert ulps <= 1, (name, step, got, want)


def _tree(rng):
    return {"a": [rng.standard_normal((5, 7)).astype(np.float32) * 3,
                  rng.standard_normal((4,)).astype(np.float32)],
            "b": {"w": rng.standard_normal((3, 6)).astype(np.float32)},
            "c": rng.standard_normal((2, 2, 3)).astype(np.float32)}


def _pair_tree(tree, dtype_of):
    """The same numpy tree as JAX arrays and CPU tensors, the i-th leaf (in
    both packages' sorted-key order) in dtype_of(i): "f32" or "bf16"."""
    index = {id(x): i for i, x in enumerate(jax.tree.leaves(tree))}
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    return (jax.tree.map(lambda x: jnp.asarray(
                x, jdt[dtype_of(index[id(x)])]), tree),
            tree_map(lambda x: torch.from_numpy(x).to(
                tdt[dtype_of(index[id(x)])]), tree))


def _assert_bf16_or_f32_close(got, want):
    g = _np(got)
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if got.dtype == torch.bfloat16:
        # one bf16 ulp (2^-7 relative to the value's binade)
        np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-30)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    rng = np.random.default_rng(0)
    jt, tt = _pair_tree(_tree(rng), lambda i: "bf16" if i % 2 else "f32")
    want, want_norm = ref_optim.clip_by_global_norm(jt, max_norm)
    got, got_norm = optim.clip_by_global_norm(tt, max_norm)
    assert abs(float(got_norm) - float(want_norm)) <= 1e-6 * float(want_norm)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                           else torch.float32)
        _assert_bf16_or_f32_close(g, w)
    assert abs(float(optim.global_norm(tt)) - float(want_norm)) \
        <= 1e-6 * float(want_norm)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_update_matches_the_reference(dtype):
    """Two updates of the launcher's optimizer: one with gradients of the
    parameters' dtype, one with float32 gradients (what grad accumulation
    hands a bf16 model), after which the moments are float32."""
    jp, tp = _pair_tree(_tree(np.random.default_rng(1)), lambda i: dtype)
    jg1, tg1 = _pair_tree(_tree(np.random.default_rng(2)), lambda i: dtype)
    jg2, tg2 = _pair_tree(_tree(np.random.default_rng(3)), lambda i: "f32")
    sched = (3e-4, 10, 50)
    ref = ref_optim.adamw(ref_optim.linear_warmup_cosine(*sched),
                          weight_decay=0.01)
    port = optim.adamw(optim.linear_warmup_cosine(*sched),
                       weight_decay=0.01)
    rs, ps = ref.init(jp), port.init(tp)
    for jg, tg in ((jg1, tg1), (jg2, tg2)):
        ru, rs = ref.update(jg, rs, jp)
        pu, ps = port.update(tg, ps, tp)
        jp = ref_optim.apply_updates(jp, ru)
        tp = optim.apply_updates(tp, pu)
        assert int(ps.step) == int(rs.step)
        for tree_g, tree_w in ((pu, ru), (ps.mu, rs.mu), (ps.nu, rs.nu),
                               (tp, jp)):
            for g, w in zip(tree_leaves(tree_g), jax.tree.leaves(tree_w)):
                want_dt = torch.bfloat16 if w.dtype == jnp.bfloat16 \
                    else torch.float32
                assert g.dtype == want_dt
                _assert_bf16_or_f32_close(g, w)
    assert all(m.dtype == torch.float32 for m in tree_leaves(ps.mu))
    # plain Adam: no decay
    a = optim.adam(1e-3, weight_decay=0.5)
    u, _ = a.update(tg1, a.init(tp), tp)
    ru, _ = ref_optim.adam(1e-3).update(jg1, ref_optim.adam(1e-3).init(jp),
                                        jp)
    for g, w in zip(tree_leaves(u), jax.tree.leaves(ru)):
        _assert_bf16_or_f32_close(g, w)


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = float(ref_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1.0)
    # bf16 logits are taken to float32 first
    got = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                        torch.from_numpy(labels))
    want = ref_cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                             jnp.asarray(labels))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


# -------------------------------------------------------------- train step
def _ref_loss(ref_cfg, chunk=CHUNK):
    def loss_fn(params, batch):
        return ref_cross_entropy(ref_forward(params, ref_cfg, batch["tokens"],
                                             ssd_chunk=chunk),
                                 batch["labels"])
    return loss_fn


def _port_loss(cfg, chunk=CHUNK):
    def loss_fn(params, batch):
        return cross_entropy(forward(params, cfg, batch["tokens"],
                                     ssd_chunk=chunk), batch["labels"])
    return loss_fn


def _launcher_opts():
    sched = (3e-4, 10, 100)
    return (ref_optim.adamw(ref_optim.linear_warmup_cosine(*sched),
                            weight_decay=0.01),
            optim.adamw(optim.linear_warmup_cosine(*sched),
                        weight_decay=0.01))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_value_and_grad(arch):
    ref_cfg, ref_params, cfg, params = _models(arch)
    jb, tb = _batch(cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(_ref_loss(ref_cfg)))(
        ref_params, jb)
    loss, grads = _value_and_grad(_port_loss(cfg), params, tb)
    assert abs(float(loss) - float(want_loss)) \
        <= LOSS_RTOL * abs(float(want_loss))
    _assert_trees_close(grads, want_grads, GRAD_TOL, f"{arch} grads")
    # the step itself: its loss, and the global norm of the reference's
    # gradients (summed in float64 here)
    _, opt = _launcher_opts()
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    new, metrics = make_train_step(cfg, opt, ssd_chunk=CHUNK)(state, tb)
    want_norm = np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                            for g in jax.tree.leaves(want_grads)))
    assert float(metrics["loss"]) == float(loss)
    assert abs(float(metrics["grad_norm"]) - want_norm) \
        <= LOSS_RTOL * want_norm
    assert int(metrics["step"]) == 1 and int(new.step) == 1
    assert int(new.opt_state.step) == 1
    assert all(not torch.equal(a, b) for a, b in zip(
        tree_leaves(new.params), tree_leaves(params)) if a.numel() > 1)


@pytest.fixture(scope="module", params=["h2o-danube-1.8b", "mamba2-130m"])
def three_steps(request):
    """The reference's jitted train step, three steps from its initial
    weights on three batches, and the states it passed through."""
    arch = request.param
    ref_cfg, ref_params, cfg, params = _models(arch)
    ref_opt, _ = _launcher_opts()
    step = jax.jit(ref_make_train_step(ref_cfg, ref_opt, ssd_chunk=CHUNK))
    state = RefTrainState(ref_params, ref_opt.init(ref_params), jnp.int32(0))
    states, losses = [state], []
    for i in range(3):
        state, m = step(state, _batch(cfg, seed=10 + i)[0])
        states.append(state)
        losses.append(float(m["loss"]))
    return arch, cfg, params, states, losses


def test_three_steps_match_the_reference(three_steps):
    arch, cfg, params, states, want_losses = three_steps
    _, opt = _launcher_opts()
    step = make_train_step(cfg, opt, ssd_chunk=CHUNK)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    for i in range(3):
        state, m = step(state, _batch(cfg, seed=10 + i)[1])
        assert abs(float(m["loss"]) - want_losses[i]) \
            <= LOSS_RTOL * want_losses[i], (arch, i)
    assert int(state.step) == 3
    _assert_trees_close(state.params, states[3].params, PARAM_TOL,
                        f"{arch} params after 3 steps")
    _assert_trees_close(state.opt_state.nu, states[3].opt_state.nu,
                        PARAM_TOL, f"{arch} nu after 3 steps")


def test_a_reference_state_continues_in_the_port(three_steps):
    """The reference's state after step 2 (params, OptState, step), carried
    across, takes the port's step 3 to the reference's step 3."""
    arch, cfg, _, states, want_losses = three_steps
    st = lm_train_state_from_numpy(jax.tree.map(np.asarray, states[2]), cfg,
                                   "cpu")
    assert int(st.step) == 2 and int(st.opt_state.step) == 2
    _, opt = _launcher_opts()
    new, m = make_train_step(cfg, opt, ssd_chunk=CHUNK)(
        st, _batch(cfg, seed=12)[1])
    assert abs(float(m["loss"]) - want_losses[2]) \
        <= LOSS_RTOL * want_losses[2]
    assert int(m["step"]) == 3
    _assert_trees_close(new.params, states[3].params, PARAM_TOL,
                        f"{arch} step 3 from the reference's state")


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-130m"])
def test_grad_accum_matches_the_reference(arch):
    ref_cfg, ref_params, cfg, params = _models(arch, grad_accum=2)
    ref_opt, opt = _launcher_opts()
    jb, tb = _batch(cfg, seed=5, b=4)
    _, want = jax.jit(ref_make_train_step(ref_cfg, ref_opt, ssd_chunk=CHUNK))(
        RefTrainState(ref_params, ref_opt.init(ref_params), jnp.int32(0)),
        jb)
    new, got = make_train_step(cfg, opt, ssd_chunk=CHUNK)(
        TrainState(params, opt.init(params),
                   torch.zeros((), dtype=torch.int32)), tb)
    for key in ("loss", "grad_norm"):
        assert abs(float(got[key]) - float(want[key])) \
            <= LOSS_RTOL * abs(float(want[key])), key
    # the f32 accumulation gives the moments f32 (they start in the
    # params' dtype, f32 here too) and one update of every leaf
    assert all(m.dtype == torch.float32 for m in tree_leaves(
        new.opt_state.mu))
    # accumulating two halves is the mean of the halves' gradients: the
    # same loss as the whole batch at once, within float32 rounding
    _, whole = make_train_step(dataclasses.replace(cfg, grad_accum=1), opt,
                               ssd_chunk=CHUNK)(
        TrainState(params, opt.init(params),
                   torch.zeros((), dtype=torch.int32)), tb)
    assert abs(float(whole["loss"]) - float(got["loss"])) \
        <= 1e-6 * float(got["loss"])


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-130m"])
def test_remat_gives_the_same_gradients_bitwise(arch):
    cfg = get(arch).smoke_config
    _, _, _, params = _models(arch)
    _, tb = _batch(cfg, seed=6)
    base = None
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        loss, grads = _value_and_grad(_port_loss(c), params, tb)
        leaves = [loss] + tree_leaves(grads)
        if base is None:
            base = leaves
            continue
        for a, b in zip(base, leaves):
            assert torch.equal(a, b), (arch, policy)
    with pytest.raises(ValueError, match="remat_policy"):
        _value_and_grad(_port_loss(dataclasses.replace(
            cfg, remat=True, remat_policy="none")), params, tb)


# ------------------------------------------------- the plain kernels' vjps
def _vjp_pair(ref_fn, port_fn, arrays, cot, **kw):
    _, vjp = jax.vjp(lambda *a: ref_fn(*a, **kw),
                     *[jnp.asarray(a) for a in arrays])
    want = vjp(jax.tree.map(jnp.asarray, cot))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = port_fn(*ins, **kw)
    torch.autograd.backward(
        out, tuple(torch.from_numpy(c) for c in cot)
        if isinstance(cot, tuple) else torch.from_numpy(cot))
    return [i.grad for i in ins], want


@pytest.mark.parametrize("causal,window,kv", [(True, 8, 2), (False, 0, 1)])
def test_flash_attention_ref_vjp_matches_the_reference(causal, window, kv):
    rng = np.random.default_rng(7)
    b, h, s, d = 2, 8, 37, 16
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    g = rng.standard_normal((b, h, s, d)).astype(np.float32)
    got, want = _vjp_pair(kref.flash_attention_ref,
                          flash_mod.flash_attention_ref, [q, k, v], g,
                          causal=causal, window=window)
    for x, w in zip(got, want):
        assert _normwise(x.numpy(), w) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 9, 64), (5, 1536)])
def test_rmsnorm_ref_vjp_matches_the_reference(shape):
    rng = np.random.default_rng(8)
    x = rng.standard_normal(shape).astype(np.float32) * 2
    scale = (rng.standard_normal(shape[-1]) + 1).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    got, want = _vjp_pair(kref.rmsnorm_ref, rms_mod.rmsnorm_ref, [x, scale],
                          g)
    for x_, w in zip(got, want):
        assert _normwise(x_.numpy(), w) <= 1e-6


def test_ssd_scan_ref_vjp_matches_the_reference():
    rng = np.random.default_rng(9)
    b, c, h, p, n = 2, 6, 3, 4, 8
    dec = (0.3 + 0.699 * rng.random((b, c, h))).astype(np.float32)
    dbx = rng.standard_normal((b, c, h, p, n)).astype(np.float32)
    gb = rng.standard_normal((b, c, h, p, n)).astype(np.float32)
    gf = rng.standard_normal((b, h, p, n)).astype(np.float32)
    got, want = _vjp_pair(kref.ssd_scan_ref, ssd_mod.ssd_scan_ref,
                          [dec, dbx], (gb, gf))
    for x, w in zip(got, want):
        assert _normwise(x.numpy(), w) <= 1e-6


# ------------------------------------------- the backward kernels' plans
# the bf16 dq kernel's plan (flash_tile_plan at 128 × 64) takes the same
# cases in tests/test_torch_flash_plan.py
_PLAN_CASES = [(256, True, 0), (300, True, 100), (1024, True, 256),
               (200, False, 0), (333, True, 64), (130, True, 1), (64, True, 0),
               (520, False, 64)]
# (block_q, block_k) of the dk/dv kernels: the f32 kernel's at danube's head
# dim 80 (the cases keep their ids; tests/test_torch_flash_tf32.py takes
# every head dim's) and the bf16 kernel's
_BWD_BLOCKS = {"tf32": flash_mod.TF32_DKV_TILES[80],
               "wgmma": (flash_mod.SM90_DKV_BLOCK_Q,
                         flash_mod.SM90_DKV_BLOCK_K)}


@pytest.mark.parametrize("s,causal,window,blocks", [
    pytest.param(*case, route, id="-".join(map(str, case))
                 + ("" if route == "tf32" else "-wgmma"))
    for route in _BWD_BLOCKS for case in _PLAN_CASES])
def test_flash_bwd_tile_plan_covers_the_mask(s, causal, window, blocks):
    bq, bk = _BWD_BLOCKS[blocks]
    mask = flash_mod.flash_mask(s, causal, window)
    if mask is None:
        mask = torch.ones(s, s, dtype=torch.bool)
    plan = flash_mod.flash_bwd_tile_plan(s, bq, bk, causal, window)
    assert len(plan) == -(-s // bk)
    for kt, tile in enumerate(plan):
        keys = slice(kt * bk, (kt + 1) * bk)
        rows = mask[:, keys].any(dim=1).nonzero().flatten()
        if rows.numel():
            # every query that sees a key of the tile is in a visited tile
            assert tile.lo <= int(rows.min()) // bq
            assert int(rows.max()) // bq <= tile.hi
        for qt in range(tile.lo, tile.hi + 1):
            block = mask[qt * bq:(qt + 1) * bq, keys]
            full = block.shape == (bq, bk) and bool(block.all())
            # an unflagged tile is wholly unmasked; a flagged one is not
            assert (qt not in tile.masked) == full, (kt, qt)
        if not causal:
            assert (tile.lo, tile.hi) == (0, -(-s // bq) - 1)


def test_backward_plans_match_the_kernel_sources():
    src = (CSRC / "rmsnorm.cu").read_text()
    assert tuple(int(n) for n in re.findall(r"RMS_BWD\((\d+)\)", src)) \
        == rms_mod.BWD_PER_THREAD
    assert f"kBwdThreads = {rms_mod.BWD_THREADS};" in src
    assert f"kBwdReduceThreads = {rms_mod.BWD_REDUCE_THREADS};" in src
    src = (CSRC / "ssd_scan.cu").read_text()
    assert tuple(int(n) for n in re.findall(r"SSD_BWD\((\d+)\)", src)) \
        == ssd_mod.BWD_PER_THREAD
    assert f"kBwdThreads = {ssd_mod.BWD_THREADS};" in src
    src = (CSRC / "flash_attention_bwd_tf32_sm90.cu").read_text()
    assert f"kDqBQ = {flash_mod.TF32_DQ_TILES[80][0]};" in src
    assert f"kDkvBK = {flash_mod.TF32_DKV_TILES[80][1]};" in src
    assert {int(d): (64, int(bk)) for d, bk in re.findall(
        r"^DQ_TILES\((\d+), (\d+)\)", src, re.M)} == flash_mod.TF32_DQ_TILES
    assert {int(d): (int(bq), 64) for d, bq in re.findall(
        r"^DKV_TILES\((\d+), (\d+)\)", src, re.M)} \
        == flash_mod.TF32_DKV_TILES
    assert tuple(int(n) for n in re.findall(r"FLASH_BWD\((\d+)\)", src)) \
        == flash_mod.HEAD_DIMS
    src = (CSRC / "flash_attention_bwd_sm90.cu").read_text()
    assert f"kDqBQ = {flash_mod.SM90_DQ_BLOCK_Q};" in src
    assert f"kDqBK = {flash_mod.SM90_DQ_BLOCK_K};" in src
    assert f"kDkvBQ = {flash_mod.SM90_DKV_BLOCK_Q};" in src
    assert f"kDkvBK = {flash_mod.SM90_DKV_BLOCK_K};" in src
    assert tuple(int(n) for n in re.findall(r"FLASH_BWD\((\d+)\)", src)) \
        == flash_mod.HEAD_DIMS


def test_backward_routes_are_the_sources_entries():
    """``_BWD_ROUTES`` names, per dtype, a library of ``_build.SOURCES`` and
    an entry its source exports, the two sources export nothing else, and
    ``route_launches`` counts exactly the routes' names."""
    from repro_torch.kernels._build import SOURCES
    exported = {}
    for lib in ("flash_attention_bwd_tf32_sm90", "flash_attention_bwd_sm90"):
        src = (CSRC / SOURCES[lib][0]).read_text()
        exported[lib] = set(re.findall(r'extern "C" int (\w+)\(', src))
    routes = flash_mod._BWD_ROUTES
    assert set(routes) == {torch.float32, torch.bfloat16}
    assert {(lib, entry) for lib, entry, _ in routes.values()} == {
        (lib, e) for lib, names in exported.items() for e in names
        if not e.endswith("_smem")}
    assert set(flash_mod.flash_attention_backward.route_launches) \
        == {route for *_, route in routes.values()} \
        == {"wgmma_tf32x3", "wgmma_bf16"}
    assert routes[torch.bfloat16][2] == flash_mod._ROUTES[torch.bfloat16][2]


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _sm90_backward_mirror(q, k, v, dout, causal, window, rnd):
    """A plain mirror of ``csrc/flash_attention_bwd_sm90.cu`` on float32
    tensors: the forward's output rounded by ``rnd`` and its rows'
    log-sum-exp in base 2 of the scores scaled by log2(e)/sqrt(D); the dq
    kernel over ``flash_tile_plan`` and the dk/dv kernel over
    ``flash_bwd_tile_plan`` at their tile sizes, on tensors padded with
    zeros to whole tiles as TMA fills them, masking only the planned tiles,
    with p = exp2(s·c − lse), dS = p·(dP − D_i), and P and dS rounded by
    ``rnd`` where they become a product's A operand → (dq, dk, dv)."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    c = scale * math.log2(math.e)
    mask = flash_mod.flash_mask(s, causal, window)
    out = rnd(flash_mod.flash_attention_ref(q, k, v, causal=causal,
                                            window=window))
    qg = q.reshape(b, kv, g, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, -math.inf)
    lse = (torch.logsumexp(scores, -1) * math.log2(math.e)).reshape(b, h, s)
    dsum = (dout * out).sum(-1)
    sp = -(-s // 128) * 128
    idx = torch.arange(sp)

    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, 0, sp - s))

    def visible(i, t):
        ok = (i < s) & (t < s)
        if causal:
            ok = ok & (t <= i)
            if window:
                ok = ok & (t > i - window)
        return ok

    qp, kp, vp, dop = (pad(x) for x in (q, k, v, dout))
    kh, vh = (x.repeat_interleave(g, 1) for x in (kp, vp))
    lse_p = torch.nn.functional.pad(lse, (0, sp - s))
    dsum_p = torch.nn.functional.pad(dsum, (0, sp - s))
    # kernel A: dq
    bq, bk = flash_mod.SM90_DQ_BLOCK_Q, flash_mod.SM90_DQ_BLOCK_K
    dq = torch.zeros(b, h, sp, d)
    for n, tile in enumerate(flash_mod.flash_tile_plan(s, bq, bk, causal,
                                                       window)):
        rows = slice(n * bq, (n + 1) * bq)
        i = idx[rows]
        lse_r = torch.where(i < s, lse_p[..., rows], math.inf)[..., None]
        for kt in range(tile.lo, tile.hi + 1):
            keys = slice(kt * bk, (kt + 1) * bk)
            p = torch.exp2(qp[:, :, rows] @ kh[:, :, keys].mT * c - lse_r)
            if kt in tile.masked:
                p = torch.where(visible(i[:, None], idx[keys][None]), p, 0.)
            ds = p * (dop[:, :, rows] @ vh[:, :, keys].mT
                      - dsum_p[..., rows, None])
            dq[:, :, rows] += rnd(ds) @ kh[:, :, keys]
    # kernel B: dk and dv, a key tile of one KV head over its group's heads
    bq, bk = flash_mod.SM90_DKV_BLOCK_Q, flash_mod.SM90_DKV_BLOCK_K
    dk, dv = torch.zeros(b, kv, sp, d), torch.zeros(b, kv, sp, d)
    qpg, dopg = (x.reshape(b, kv, g, sp, d) for x in (qp, dop))
    lse_g, dsum_g = (x.reshape(b, kv, g, sp) for x in (lse_p, dsum_p))
    for n, tile in enumerate(flash_mod.flash_bwd_tile_plan(s, bq, bk, causal,
                                                           window)):
        keys = slice(n * bk, (n + 1) * bk)
        for j in range(g):
            for qt in range(tile.lo, tile.hi + 1):
                rows = slice(qt * bq, (qt + 1) * bq)
                i = idx[rows]
                lse_r = torch.where(i < s, lse_g[:, :, j, rows], 0.)
                dsum_r = torch.where(i < s, dsum_g[:, :, j, rows], 0.)
                p = torch.exp2(kp[:, :, keys] @ qpg[:, :, j, rows].mT * c
                               - lse_r[..., None, :])
                if qt in tile.masked:
                    p = torch.where(visible(i[None], idx[keys][:, None]), p,
                                    0.)
                ds = p * (vp[:, :, keys] @ dopg[:, :, j, rows].mT
                          - dsum_r[..., None, :])
                dv[:, :, keys] += rnd(p) @ dopg[:, :, j, rows]
                dk[:, :, keys] += rnd(ds) @ qpg[:, :, j, rows]
    return (rnd(dq[:, :, :s] * scale), rnd(dk[:, :, :s] * scale),
            rnd(dv[:, :, :s]))


@pytest.mark.parametrize("precision,tol", [("f32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", [
    (1, 4, 2, 333, 80, True, 100), (2, 2, 1, 200, 64, False, 0),
    (1, 4, 4, 300, 96, True, 0), (1, 2, 1, 130, 128, True, 3)])
def test_sm90_backward_mirror_matches_the_reference_vjp(
        b, h, kv, s, d, causal, window, precision, tol):
    """The bf16 backward's algorithm (its plans, masks, base-2 log-sum-exp
    and D_i) against ``jax.vjp`` of the reference's attention: to 1e-5 in
    float32, and within bf16's 2e-2 (chip_smoke.py's bound for the kernel)
    where the output, P and dS are rounded to bf16 as the kernels round
    them.  The inputs are bf16 values in float32."""
    rng = np.random.default_rng(26)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    g = rng.standard_normal((b, h, s, d)).astype(np.float32)
    q, k, v, g = (_bf16(torch.from_numpy(x)).numpy() for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda *a: kref.flash_attention_ref(
        *a, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    rnd = _bf16 if precision == "bf16" else (lambda x: x)
    got = _sm90_backward_mirror(*map(torch.from_numpy, (q, k, v, g)),
                                causal, window, rnd)
    for x, w in zip(got, want):
        assert _normwise(x.numpy(), np.asarray(w)) <= tol


@pytest.mark.parametrize("rows,d", [(1, 1), (4, 768), (32768, 2560),
                                    (32768, 1536), (5, 8192), (1000, 37)])
def test_rmsnorm_bwd_plan_covers_every_row(rows, d):
    plan = rms_mod.rmsnorm_bwd_plan(rows, d)
    assert plan.per_thread * rms_mod.BWD_THREADS >= d
    assert plan.per_thread in rms_mod.BWD_PER_THREAD
    assert plan.blocks * plan.rows_per_block >= rows
    assert (plan.blocks - 1) * plan.rows_per_block < rows
    assert plan.blocks <= max(rms_mod.BWD_TARGET_BLOCKS, 1)
    with pytest.raises(ValueError, match="width"):
        rms_mod.rmsnorm_bwd_plan(4, 8193)
    assert ssd_mod.ssd_scan_bwd_plan(64 * 128) == 16
    with pytest.raises(ValueError, match="exceeds"):
        ssd_mod.ssd_scan_bwd_plan(32 * 512 + 1)


def test_backward_wrappers_raise_off_the_card():
    """The backward entry points take CUDA tensors only (a CPU tensor is
    differentiated through its plain version by autograd)."""
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rms_mod.rmsnorm_backward(x.to("meta"), torch.zeros(8, device="meta"),
                                 x.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ssd_mod.ssd_scan_backward(torch.zeros(1, 2, 1, device="meta"),
                                  *(torch.zeros(1, 2, 1, 2, 2,
                                                device="meta"),) * 2,
                                  torch.zeros(1, 1, 2, 2, device="meta"))


# -------------------------------------------------------------- checkpoints
def _ref_state(ref_cfg, ref_params, rng):
    """A reference TrainState with moments of two dtypes (mu bf16, nu f32)
    and nonzero steps."""
    mu = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape), jnp.bfloat16), ref_params)
    nu = jax.tree.map(lambda p: jnp.asarray(
        rng.random(p.shape), jnp.float32), ref_params)
    return RefTrainState(ref_params,
                         ref_optim.OptState(jnp.int32(5), mu, nu),
                         jnp.int32(5))


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("async_save", [False, True])
def test_train_state_checkpoints_cross_between_packages_bitwise(
        tmp_path, async_save):
    ref_cfg, ref_params, cfg, _ = _models("h2o-danube-1.8b",
                                          dtype="bfloat16")
    ref_state = _ref_state(ref_cfg, ref_params, np.random.default_rng(0))
    state = lm_train_state_from_numpy(jax.tree.map(np.asarray, ref_state),
                                      cfg, "cpu")
    like = tree_map(torch.zeros_like, state)
    ref_like = jax.tree.map(jnp.zeros_like, ref_state)

    ref_mgr = RefManager(str(tmp_path / "ref"), async_save=async_save)
    ref_mgr.save(5, ref_state)
    ref_mgr.wait()
    ref_mgr.close()
    got = CheckpointManager(str(tmp_path / "ref")).restore(5, like)
    assert isinstance(got, TrainState)
    for g, w in zip(tree_leaves(got), tree_leaves(state)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(_bits(g), _bits(w))

    mgr = CheckpointManager(str(tmp_path / "port"), async_save=async_save)
    mgr.save(5, state)
    mgr.wait()
    mgr.close()
    want = RefManager(str(tmp_path / "port")).restore(5, ref_like)
    for g, w in zip(jax.tree.leaves(want), jax.tree.leaves(ref_state)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(_bits(g), _bits(w))
    with np.load(tmp_path / "ref" / "step_0000000005" / "state.npz") as a, \
            np.load(tmp_path / "port" / "step_0000000005" / "state.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "opt_state/mu/embed" in a.files and "step" in a.files


def test_async_save_surfaces_its_error_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    mgr.save(1, {"a": np.zeros(3, np.float32)})
    mgr.wait()
    assert mgr.latest_step() == 1
    mgr.save(2, {"a": np.zeros(3, np.float32)}, meta={"bad": object()})
    with pytest.raises(TypeError):
        mgr.wait()
    mgr.close()
    with pytest.raises(RuntimeError, match="closed"):
        mgr.save(3, {"a": np.zeros(3, np.float32)})
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [1]


# ----------------------------------------------------------------- launcher
def test_launch_train_runs_and_resumes_on_the_cpu(tmp_path):
    common = ["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
              "--global-batch", "2", "--seq", "16", "--ckpt-every", "2"]
    first = train_launcher.main(common + ["--steps", "3", "--ckpt-dir",
                                          str(tmp_path / "a")])
    assert first.start == 0 and len(first.losses) == 3
    assert np.isfinite(first.losses).all() and first.peak_bytes == 0
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [2, 3]
    resumed = train_launcher.main(common + ["--steps", "5", "--ckpt-dir",
                                            str(tmp_path / "a")])
    assert resumed.start == 3 and len(resumed.losses) == 2
    straight = train_launcher.main(common + ["--steps", "5", "--ckpt-dir",
                                             str(tmp_path / "b")])
    # the CPU is deterministic: the resumed steps are the straight run's
    assert resumed.losses == straight.losses[3:]
    assert first.losses == straight.losses[:3]
    for a, b in zip(tree_leaves(resumed.state), tree_leaves(straight.state)):
        assert torch.equal(a, b)
    none = train_launcher.main(common[:-2] + ["--ckpt-every", "0",
                                              "--steps", "1", "--ckpt-dir",
                                              str(tmp_path / "c")])
    assert len(none.losses) == 1 and not (tmp_path / "c").exists()
