"""Port parity, the distribution substrate (``repro_torch.distributed``):
the logical-axis rules against the reference's (axis filtering, the rules
context under exceptions), int8 quantization bit for bit, the watchdog and
``choose_mesh_shape``, the elastic controller and the preemption flusher;
and on four gloo ranks the compressed mean all-reduce and its error
feedback, the pipeline (plain and plan-driven) against sequential
execution, DTensor placements and an elastic restore onto a mesh.

Multi-rank checks run in spawned processes that meet over a ``FileStore``
in the test's ``tmp_path`` (never a fixed port: the suite runs in
parallel); one spawn runs every check of its mesh.  JAX is imported only
inside the tests, so the spawned ranks never load it."""
import json
import os
import signal
import subprocess
import sys
import textwrap
import types
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch import distributed as D  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")


# ------------------------------------------------------------- the spawner
def spawn_ranks(module: str, fn: str, world: int, tmp_path, *args,
                timeout: int = 150) -> list:
    """Run ``module.fn(rank, world, out_dir, *args)`` in ``world`` fresh
    processes joined into one gloo group over a FileStore under
    ``tmp_path`` → each rank's JSON result (what ``fn`` returned)."""
    out = str(tmp_path)
    code = textwrap.dedent(f"""
        import json, sys
        import test_torch_distributed as d
        import {module} as m
        rank = int(sys.argv[1])
        res = d._as_rank(rank, {world}, {out!r}, m.{fn}, *{args!r})
        with open({out!r} + f"/rank{{rank}}.json", "w") as f:
            json.dump(res, f)
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, TESTS]),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errs.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errs, "\n".join(errs)
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _as_rank(rank, world, out_dir, fn, *args):
    """One spawned rank: join the group, run ``fn``, leave the group."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=timedelta(seconds=90))
    try:
        return fn(rank, world, out_dir, *args)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------- rules
def _rule_keys():
    return sorted(sharding.DEFAULT_RULES)


def _entries(spec):
    """Spec entries as JAX's PartitionSpec compares them: a one-axis tuple
    is that axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.mark.parametrize("names", [None, ("data", "model"),
                                   ("pod", "data", "model"), ("model",)])
def test_rules_resolve_like_the_reference(names):
    """Every logical axis of the default rules, with an override and the
    rollout rules, resolves to the reference's PartitionSpec entries; mesh
    axes absent from the mesh are dropped as the reference drops them."""
    import jax
    from jax.sharding import Mesh
    from repro.distributed import sharding as ref
    mesh = ref_mesh = None
    if names is not None:
        mesh = types.SimpleNamespace(mesh_dim_names=names)
        ref_mesh = Mesh(np.array(jax.devices()[:1]).reshape(
            (1,) * len(names)), names)
    axes = tuple(_rule_keys()) + (None, "unknown")
    for rules, ref_rules in (
            (D.with_rules({"kv_heads": None, "embed": "data"}),
             ref.with_rules({"kv_heads": None, "embed": "data"})),
            (D.DEFAULT_RULES, ref.DEFAULT_RULES)):
        assert _entries(D.logical_spec(axes, rules, mesh)) == _entries(
            ref.logical_spec(axes, ref_rules, ref_mesh))
    spec = ("time", "graphs", "chains")
    assert D.logical_spec(spec, D.ROLLOUT_RULES) == tuple(
        ref.logical_spec(spec, ref.ROLLOUT_RULES)) == (None, "graphs",
                                                        "chains")
    # the reference's own examples
    rules = D.with_rules({"kv_heads": None})
    assert D.logical_spec(("batch", "act_seq", "heads", "head_dim"),
                          rules) == (("pod", "data"), None, "model", None)
    assert D.logical_spec(("batch", "act_embed"), rules,
                          types.SimpleNamespace(
                              mesh_dim_names=("data", "model"))) \
        == (("data",), None)


def test_use_rules_restores_on_exception():
    """The context restores mesh+rules when the body raises, and a rules
    mapping that fails to merge leaves the outer context intact."""
    from collections.abc import Mapping
    assert D.sharding.current_mesh() is None
    with pytest.raises(RuntimeError):
        with D.use_rules("outer-mesh", {"batch": "data"}):
            assert sharding.current_mesh() == "outer-mesh"
            with pytest.raises(RuntimeError):
                with D.use_rules("inner-mesh", {"batch": None}):
                    assert sharding.current_mesh() == "inner-mesh"
                    raise RuntimeError("inner boom")
            assert sharding.current_mesh() == "outer-mesh"
            assert sharding._CTX.rules["batch"] == "data"
            raise RuntimeError("outer boom")
    assert sharding.current_mesh() is None
    assert sharding._CTX.rules is None

    class BoomMapping(Mapping):
        def __getitem__(self, k):
            raise RuntimeError("bad rules")

        def __iter__(self):
            return iter(["batch"])

        def __len__(self):
            return 1

        def keys(self):
            raise RuntimeError("bad rules")

    with D.use_rules("outer-mesh"):
        with pytest.raises(RuntimeError, match="bad rules"):
            with D.use_rules("inner-mesh", BoomMapping()):
                pass                             # pragma: no cover
        assert sharding.current_mesh() == "outer-mesh"
    assert sharding.current_mesh() is None
    x = torch.ones(3)
    assert D.shard(x, "batch") is x              # no rules context


# ------------------------------------------------------------- compression
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_int8_is_the_references_bitwise(seed):
    """Values, scales and the dequantized vector equal the reference's bit
    for bit, on blocks of mixed scale, a zero block and exact halves (both
    round half to even)."""
    import jax.numpy as jnp
    from repro.distributed import compression as ref
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 2048)).astype(np.float32)
         * rng.uniform(1e-3, 30.0, (3, 1)).astype(np.float32))
    x[1, :256] = 0.0
    x[2, :256] = (np.arange(256, dtype=np.float32) - 128.0) * 0.5
    x[2, 0] = -127.0                             # scale 1: every .5 a tie
    q, s = D.quantize_int8(torch.from_numpy(x))
    rq, rs = ref.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        D.dequantize_int8(q, s).numpy(),
        np.asarray(ref.dequantize_int8(rq, rs)))
    # the reference's bound: per-block error ≤ amax/254
    err = np.abs(D.dequantize_int8(q, s).numpy() - x).reshape(-1, 256)
    bound = np.abs(x).reshape(-1, 256).max(1) / 254.0 + 1e-7
    assert np.all(err.max(1) <= bound * 1.01)


# ------------------------------------------------------------------ elastic
def test_watchdog_and_mesh_shape_match_the_reference():
    from repro.distributed import elastic as ref
    rng = np.random.default_rng(3)
    times = np.concatenate([np.ones(6), [5.0, 1.0], rng.uniform(
        0.5, 4.0, 40)]).tolist()
    for kw in (dict(threshold=2.0, warmup_steps=2),
               dict(threshold=1.5, beta=0.5, warmup_steps=0), {}):
        mine, want = D.StragglerWatchdog(**kw), ref.StragglerWatchdog(**kw)
        assert [mine.record(i, t) for i, t in enumerate(times)] == \
            [want.record(i, t) for i, t in enumerate(times)]
        assert mine.flagged == want.flagged and mine.ema == want.ema
    wd = D.StragglerWatchdog(threshold=2.0, warmup_steps=2)
    assert [wd.record(i, t) for i, t in enumerate(times[:8])] == \
        [False] * 6 + [True, False]
    for n in (1, 7, 16, 240, 250, 256):
        for mp in (1, 2, 3, 16):
            assert D.choose_mesh_shape(n, mp) == ref.choose_mesh_shape(n, mp)
    assert D.choose_mesh_shape(250, 16) == (125, 2)


def test_elastic_controller_and_preemption_flusher(tmp_path):
    """With no process group and no card the controller picks the 1×1
    mesh (the reference's on one device), restores the latest step, and
    starts at 0 on an empty directory; SIGTERM flushes a final
    checkpoint."""
    from repro.distributed import elastic as ref
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "layers": [{"b": np.ones(2, np.float32)}]}
    ctl = D.ElasticController(CheckpointManager(str(tmp_path / "c")),
                              make_mesh=lambda d, m: (d, m))
    assert ctl.resume(tree) == ((1, 1), None, 0)
    ctl.ckpt.save(4, tree)
    mesh, state, step = ctl.resume(tree)
    assert mesh == ref.choose_mesh_shape(1, 1) and step == 4
    np.testing.assert_array_equal(state["w"], tree["w"])
    np.testing.assert_array_equal(state["layers"][0]["b"],
                                  tree["layers"][0]["b"])
    prev = signal.getsignal(signal.SIGTERM)
    try:
        mgr = CheckpointManager(str(tmp_path / "p"))
        fl = D.PreemptionFlusher(mgr)
        assert signal.getsignal(signal.SIGTERM) == fl._handler
        fl._handler(signal.SIGTERM, None)        # nothing to save yet
        assert fl.preempted and mgr.latest_step() is None
        fl.update(7, tree)
        fl._handler(signal.SIGTERM, None)
        assert mgr.latest_step() == 7
        assert mgr.manifest(7)["preempted"] is True
    finally:
        signal.signal(signal.SIGTERM, prev)


# ------------------------------------------------------- four gloo ranks
def _stage_fn(w, x):
    return torch.tanh(x @ w)


def _layers_fn(ws, x):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


def _rank_four(rank, world, out_dir, per_stage):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    res = {}
    # -- compressed mean all-reduce: the reference's bound of the mean
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((world, 8 * 256 * world)).astype(np.float32)
    got = D.compressed_psum_mean(torch.from_numpy(xs[rank])).numpy()
    want = xs.mean(0)
    res["psum_rel"] = float(np.abs(got - want).max()
                            / (np.abs(want).max() + 1e-9))
    # -- error feedback: the accumulated mean approaches the exact one
    g = np.random.default_rng(1).standard_normal((world, 2048)) \
        .astype(np.float32)
    err, acc = None, np.zeros(2048, np.float32)
    for _ in range(8):
        (red,), err = D.compressed_allreduce_tree(
            [torch.from_numpy(g[rank])], error_fb=err)
        acc += red.numpy()
    want = g.mean(0) * 8
    res["ef_rel"] = float(np.abs(acc - want).max() / np.abs(want).max())
    # -- the pipeline against sequential execution, forward and grads
    d, M = 16, 6
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(world, d, d, generator=gen) / np.sqrt(d)
    xs = torch.randn(M, 3, d, generator=gen)
    for remat in (True, False):
        mine = w[rank].clone().requires_grad_(True)
        out = D.pipeline_apply(_stage_fn, mine, xs, remat_stage=remat)
        (out ** 2).sum().backward()
        full = w.clone().requires_grad_(True)
        ref = xs
        for s in range(world):
            ref = torch.tanh(ref @ full[s])
        (ref ** 2).sum().backward()
        res[f"pipe_fwd_{remat}"] = float((out - ref).abs().max())
        res[f"pipe_grad_{remat}"] = float(
            (mine.grad - full.grad[rank]).abs().max())
    # -- the plan-driven pipeline: the planner's stage split of a uniform
    # stack, balanced to equal stages, as tests/test_pipeline_planner.py
    L = world * per_stage
    wl = torch.randn(L, 32, 32, generator=gen) / np.sqrt(32)
    xs = torch.randn(6, 3, 32, generator=gen)
    fn = D.make_pipeline_fn(_layers_fn)
    out = fn(wl[rank * per_stage:(rank + 1) * per_stage], xs)
    res["plan_fwd"] = float((out - _layers_fn(wl, xs)).abs().max())
    # -- DTensor placements on a (data, model) mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res["filtered"] = list(D.logical_spec(("batch", "act_embed"),
                                          D.with_rules({}), mesh)[0])
    specs = D.param_specs({"w": ("embed", "mlp"), "b": [("batch",)]}, mesh)
    res["param_specs"] = (specs["w"] == [Replicate(), Shard(1)]
                          and specs["b"][0] == [Shard(0), Replicate()])
    x = torch.arange(16.0).reshape(4, 4)
    with D.use_rules(mesh):
        y = D.shard(x, "batch", "mlp")
        z = D.shard(y, None, "mlp")
    res["shard"] = (isinstance(y, DTensor)
                    and tuple(y.placements) == (Shard(0), Shard(1))
                    and tuple(y.to_local().shape) == (2, 2)
                    and tuple(z.placements) == (Replicate(), Shard(1))
                    and torch.equal(z.full_tensor(), x))
    # -- an elastic restore onto the live ranks' mesh: 4 ranks at model
    # parallel 2 → (2, 2), leaves distributed as their logical axes say
    ckdir = os.path.join(out_dir, "elastic")
    tree = {"w": np.arange(16, dtype=np.float32).reshape(4, 4)}
    if rank == 0:
        CheckpointManager(ckdir).save(3, tree)
    dist.barrier()
    ctl = D.ElasticController(
        CheckpointManager(ckdir), model_parallel=2,
        make_mesh=lambda a, b: init_device_mesh(
            "cpu", (a, b), mesh_dim_names=("data", "model")))
    m2, state, step = ctl.resume(tree, sharding_fn=lambda m, t: D.param_specs(
        {"w": ("batch", "mlp")}, m))
    res["elastic"] = (tuple(m2.shape) == (2, 2) and step == 3
                      and tuple(state["w"].placements) == (Shard(0),
                                                           Shard(1))
                      and torch.equal(state["w"].full_tensor(),
                                      torch.from_numpy(tree["w"])))
    return res


def test_four_gloo_ranks(tmp_path):
    """Four gloo ranks: the compressed mean within the reference's bound
    (2e-2), error feedback converging (5e-3), the pipeline against
    sequential execution (forward 1e-5, grads 1e-4, with and without
    remat), the plan-driven pipeline, DTensor placements and an elastic
    restore onto a (2, 2) mesh."""
    from repro_torch.core import HSDAGConfig
    from repro_torch.core.graph import topological_order
    from repro_torch.core.planner import plan_stages
    from repro_torch.models import ModelConfig
    S, L = 4, 8
    cfg = ModelConfig(name="plan-demo", n_layers=L, d_model=32, n_heads=4,
                      n_kv_heads=4, d_ff=64, vocab_size=64, dtype="float32")
    plan = plan_stages(cfg, seq_len=64, batch=4, num_stages=S,
                       hsdag_cfg=HSDAGConfig(num_devices=S, max_episodes=3,
                                             update_timestep=6,
                                             hidden_channel=32),
                       device="cpu")
    stages = plan.stage_of_node[topological_order(plan.graph)]
    assert np.all(np.diff(stages) >= 0)          # contiguous stages
    for res in spawn_ranks("test_torch_distributed", "_rank_four", S,
                           tmp_path, L // S):
        assert res["psum_rel"] < 2e-2, res
        assert res["ef_rel"] < 5e-3, res
        for remat in (True, False):
            assert res[f"pipe_fwd_{remat}"] < 1e-5, res
            assert res[f"pipe_grad_{remat}"] < 1e-4, res
        assert res["plan_fwd"] < 1e-5, res
        assert res["filtered"] == ["data"], res
        assert res["param_specs"] and res["shard"] and res["elastic"], res
