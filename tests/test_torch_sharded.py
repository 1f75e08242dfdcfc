"""Port parity, the sharded rollout engine (``core/sim/sharded.py``) and
the corpus trainer on a mesh.

* mesh 1×1 trains **bit for bit** like ``mesh_shape=None`` (params, bests,
  greedy latencies), with and without the episodic population; a v1 spec's
  ``"mesh"`` and a resume across 1×1 and unsharded runs do too;
* on 1×2 and 2×2 gloo meshes the first window's gathered placements and
  rewards are bitwise the unsharded run's, and the final params within
  1e-5 (the gradients summed over the mesh are the only delta); every rank
  ends with the same params;
* the 1×2 mesh with ``update="fused"`` on the reference's draws against
  the reference's own 1×2 run on two virtual XLA devices: the first
  window's placements bitwise, rewards and latencies at the unsharded
  comparison's tolerance, the sampled slots, the final params within 1e-5;
* ``window_grads`` on a 1×2 mesh against ``MultiRolloutEngine``'s on the
  whole grid at float32 rounding (a wrong global divisor fails it);
* ``window_weights`` against the reference's ``ShardedRolloutEngine`` and
  the host float64 path; ``pbt_step`` on a 1×2 mesh bitwise
  ``MultiRolloutEngine.pbt_step``;
* the tiling and world-size errors, and resume refusing another mesh.

Multi-rank runs spawn gloo processes (``test_torch_distributed.
spawn_ranks``), one spawn per mesh shape."""
import hashlib
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import HSDAGConfig, paper_platform  # noqa: E402
from repro_torch.checkpoint import params_to_numpy  # noqa: E402
from repro_torch.core.sim import RolloutEngine, sharded  # noqa: E402
from repro_torch.core.sim.rollout import WindowNoise  # noqa: E402
from repro_torch.core.sim.sharded import (LocalMesh,  # noqa: E402
                                          ShardedRolloutEngine,
                                          make_rollout_mesh)
from repro_torch.core.train import loop  # noqa: E402
from repro_torch.core.train.curriculum import CurriculumTrainer  # noqa: E402
from repro_torch.core.train.loop import window_weights  # noqa: E402
from repro_torch.graphs import build_corpus  # noqa: E402

from test_torch_distributed import SRC, TESTS, spawn_ranks  # noqa: E402

CFG_KW = dict(num_devices=2, hidden_channel=16, max_episodes=3,
              update_timestep=2, batch_chains=4)
SPEC = "synthetic:family=mixed:count=8:size=14:seed=0"
TRAINER = dict(max_buckets=2, graphs_per_episode=4)
#: the episodic population (a cull every episode)
POP = {"cull_every": 1}
#: rewards and latencies of one placement, port against reference: their
#: schedulers round differently (``test_torch_hsdag.TOL``)
TOL = 1e-5


def _train(mesh_shape=None, population=None, **kw):
    """A corpus run on the CPU → (result, the first window's gathered
    placements, rewards and latencies, {"weights": window_weights calls,
    "greedy": greedy decodes})."""
    first, calls = [], {"weights": 0, "greedy": 0}
    update, weights = loop.BestTracker.update, \
        ShardedRolloutEngine.window_weights
    rollout = RolloutEngine.rollout_window

    def spy(self, fines, rewards, latencies, *a, **k):
        if not first:
            first.append(([f.copy() for f in fines], rewards.copy(),
                          latencies.copy()))
        return update(self, fines, rewards, latencies, *a, **k)

    def counted(self, *a, **k):
        calls["weights"] += 1
        return weights(self, *a, **k)

    def decodes(self, *a, **k):
        calls["greedy"] += bool(k.get("greedy"))
        return rollout(self, *a, **k)

    loop.BestTracker.update = spy
    ShardedRolloutEngine.window_weights = counted
    RolloutEngine.rollout_window = decodes
    try:
        trainer = CurriculumTrainer(
            HSDAGConfig(**dict(CFG_KW, **kw.pop("cfg", {}))),
            mesh_shape=mesh_shape, population=population, device="cpu",
            **dict(TRAINER, **kw.pop("trainer", {})))
        res = trainer.train_corpus(build_corpus(SPEC),
                                   platform=paper_platform(), **kw)
    finally:
        loop.BestTracker.update = update
        ShardedRolloutEngine.window_weights = weights
        RolloutEngine.rollout_window = rollout
    return res, first[0] if first else None, calls


def _params(res):
    return [p.detach().clone() for p in res.params.parameters()]


def _same_window(a, b) -> bool:
    return (all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
            and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]))


def _digest(params) -> str:
    return hashlib.sha256(b"".join(p.numpy().tobytes()
                                   for p in params)).hexdigest()


def _assert_same_run(got, want):
    for p, q in zip(_params(got), _params(want)):
        assert torch.equal(p, q)
    np.testing.assert_array_equal(got.best_latencies, want.best_latencies)
    np.testing.assert_array_equal(got.greedy_latencies,
                                  want.greedy_latencies)
    for p, q in zip(got.best_placements, want.best_placements):
        np.testing.assert_array_equal(p, q)
    assert [h["graphs"] for h in got.history] == \
        [h["graphs"] for h in want.history]


# ----------------------------------------------------------------- 1×1
@pytest.mark.parametrize("population", [None, POP])
def test_mesh_1x1_trains_bit_for_bit_like_the_unsharded_run(population):
    """mesh=1×1 is the unsharded run, bit for bit: params, bests, greedy,
    the first window; "auto" keeps the host weights there, and the greedy
    decodes of a short chunk padded to the mesh decode its graphs only."""
    want, want_first, want_calls = _train(None, population)
    got, got_first, calls = _train((1, 1), population)
    _assert_same_run(got, want)
    assert _same_window(got_first, want_first)
    assert calls["weights"] == 0
    assert calls["greedy"] == want_calls["greedy"] == 8
    for a, b in zip(got.history, want.history):
        assert a["mean_reward"] == b["mean_reward"]
        if population is not None:
            assert a["pop_best_latency"] == b["pop_best_latency"]
            assert a["temp_mean"] == b["temp_mean"]


def test_resume_across_1x1_and_unsharded(tmp_path):
    """A checkpoint of either run resumes in the other (1×1 and None are
    the same run); the manifest records the mesh."""
    from repro_torch.checkpoint import CheckpointManager
    want, _, _ = _train(None)
    for first, then in ((None, (1, 1)), ((1, 1), None)):
        d = str(tmp_path / f"{first}")
        _train(first, episodes=2, checkpoint_dir=d, checkpoint_every=1)
        mgr = CheckpointManager(d)
        assert mgr.manifest(mgr.latest_step())["mesh"] == \
            (None if first is None else [1, 1])
        got, _, _ = _train(then, checkpoint_dir=d, resume=True)
        for p, q in zip(_params(got), _params(want)):
            assert torch.equal(p, q)
        np.testing.assert_array_equal(got.best_latencies,
                                      want.best_latencies)


def _stand_in_engines(n):
    """Engines enough for ``window_weights``: it reads only the device."""
    import types
    return [types.SimpleNamespace(
        x0=torch.zeros(1, 1), policy=None,
        graph=types.SimpleNamespace(num_nodes=3)) for _ in range(n)]


@pytest.mark.parametrize("rtg,norm", [(False, False), (False, True),
                                      (True, False), (True, True)])
def test_window_weights_match_the_reference_and_the_host(rtg, norm):
    """The in-mesh float32 weights at 1×1 against the reference's
    ``ShardedRolloutEngine.window_weights`` on the same rewards (1e-6) and
    against the host float64 path (the reference's atol 1e-5 / rtol
    1e-4), with per-graph standardization and without."""
    from repro.core.hsdag import HSDAGConfig as RefConfig
    from repro.core.sim import ShardedRolloutEngine as RefEngine
    ref = RefEngine(lambda *a, **k: None, RefConfig(), mesh_shape=(1, 1))
    eng = ShardedRolloutEngine(_stand_in_engines(2), num_nodes=[3, 3],
                               mesh=LocalMesh())
    rewards = (np.random.default_rng(0).standard_normal((5, 2, 4))
               .astype(np.float32) * 3.0)
    for norm_kind, gamma in (("pergraph", 0.97), ("none", 1.0)):
        kw = dict(gamma=gamma, reward_to_go=rtg, normalize=norm,
                  reward_norm=norm_kind)
        got = eng.window_weights(torch.from_numpy(rewards), **kw).numpy()
        np.testing.assert_allclose(
            got, np.asarray(ref.window_weights(rewards, **kw)),
            rtol=0, atol=1e-6)
        cfg = HSDAGConfig(gamma=gamma, reward_to_go=rtg,
                          normalize_weights=norm)
        np.testing.assert_allclose(
            got, window_weights(rewards.astype(np.float64), cfg,
                                reward_norm=norm_kind),
            atol=1e-5, rtol=1e-4)


def test_tiling_and_world_size_errors_have_the_references_words():
    """The trainer's and the engine's tiling errors are the reference's
    text; a mesh larger than the ranks names torchrun and
    init_process_group; bad shapes and update modes raise."""
    from repro.core import paper_platform as ref_paper
    from repro.core.hsdag import HSDAGConfig as RefConfig
    from repro.core.sim import ShardedRolloutEngine as RefEngine
    from repro.core.train.curriculum import CurriculumTrainer as RefTrainer
    from repro.graphs import build_corpus as ref_corpus
    spec = "synthetic:count=4:size=12:seed=1"
    for cfg_kw, kw in ((CFG_KW, dict(graphs_per_episode=3,
                                     mesh_shape=(2, 1))),
                       (dict(CFG_KW, batch_chains=3),
                        dict(graphs_per_episode=2, mesh_shape=(1, 2)))):
        with pytest.raises(ValueError) as want:
            RefTrainer(RefConfig(**cfg_kw), **kw).train_corpus(
                ref_corpus(spec), platform=ref_paper())
        with pytest.raises(ValueError) as got:
            CurriculumTrainer(HSDAGConfig(**cfg_kw), device="cpu",
                              **kw).train_corpus(
                build_corpus(spec), platform=paper_platform())
        assert str(got.value) == str(want.value)
        assert "does not tile the mesh" in str(got.value)
    ref = RefEngine(lambda *a, **k: None, RefConfig(), mesh_shape=(1, 1))
    ref._gm, ref._bm = 2, 4
    for G, B in ((3, 4), (2, 6)):
        with pytest.raises(ValueError) as want:
            ref._check_tiling(G, B)
        with pytest.raises(ValueError) as got:
            sharded._check_tiling(2, 4, G, B)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node=4 .*"
                                         "init_process_group"):
        make_rollout_mesh(2, 2)
    with pytest.raises(ValueError, match="must be positive"):
        CurriculumTrainer(HSDAGConfig(**CFG_KW), mesh_shape=(0, 2),
                          device="cpu")
    with pytest.raises(ValueError, match="unknown update mode"):
        CurriculumTrainer(HSDAGConfig(**CFG_KW), update="psum",
                          device="cpu")
    with pytest.raises(ValueError, match="unknown weights mode"):
        loop.EpisodeRunner(None, None, pipeline=None, tracker=None,
                           weights="psum")
    assert isinstance(make_rollout_mesh(1, 1), LocalMesh)


# ------------------------------------------------------------ gloo meshes
def _train_pair(mesh_shape, population=None):
    """The unsharded and the sharded run in this rank's process → the
    parity facts the parent checks."""
    want, want_first, _ = _train(None, population)
    got, got_first, calls = _train(mesh_shape, population)
    mine = _params(got)
    return {
        "first_window_bitwise": _same_window(got_first, want_first),
        "max_param_diff": max(float((p - q).abs().max())
                              for p, q in zip(mine, _params(want))),
        "params": _digest(mine),
        "best": got.best_latencies.tolist(),
        "greedy": got.greedy_latencies.tolist(),
        "window_weights_calls": calls["weights"],
        "greedy_decodes": calls["greedy"],
    }


def _pbt_case(mesh):
    """``pbt_step`` (both kinds of restart), ``update_population`` and
    ``gather_population`` on ``mesh`` against ``MultiRolloutEngine``'s on
    the whole grid, bitwise → {check: bool}."""
    from repro_torch._device import seeded_generator
    from repro_torch.core import HSDAG, extract_features
    from repro_torch.core.features import shared_feature_config
    from repro_torch.core.sim import MultiRolloutEngine
    from repro_torch.core.train import PopulationConfig
    graphs = build_corpus("synthetic:family=mixed:count=2:size=10:seed=3")
    fc = shared_feature_config(graphs)
    arrays = [extract_features(g, fc) for g in graphs]
    agent = HSDAG(HSDAGConfig(**CFG_KW), device="cpu")
    agent.init(arrays[0])
    engines = [agent.rollout_engine(a) for a in arrays]
    cfg = PopulationConfig(cull_every=1)
    full = MultiRolloutEngine(engines, population=cfg)
    eng = ShardedRolloutEngine(engines, num_nodes=full.num_nodes,
                               mesh=mesh, population=cfg)
    G, B = 2, 4
    gsl, bsl = sharded.rollout_tile(mesh, G, B)
    gen = torch.Generator().manual_seed(5)
    V = max(full.num_nodes)
    pop = full.init_population(seeded_generator([1], "cpu"), num_chains=B)
    # row 0's best chain is on the first chain shard, row 1's on the
    # second; ties in both rows
    pop = pop._replace(
        best_latency=torch.tensor([[3.0, 1.0, 1.0, 2.0],
                                   [5.0, 4.0, 6.0, 2.0]]),
        best_fine=torch.randint(0, 2, (G, B, V), generator=gen))
    # window-end states (a greedy restart's shape), made distinct
    zs = full.rollout_window(full.initial_state(B), num_steps=1,
                             start_first=True,
                             streams=loop.make_chain_streams(3, G, B, "cpu"))[0]
    zs = [z + torch.randn(z.shape, generator=gen) for z in zs]
    out = {}
    for greedy in (False, True):
        want_pop, want_zs = full.pbt_step(
            pop._replace(rng=seeded_generator([9], "cpu")), zs,
            use_greedy=greedy)
        tile = pop._replace(temperature=pop.temperature[gsl, bsl],
                            best_latency=pop.best_latency[gsl, bsl],
                            best_fine=pop.best_fine[gsl, bsl],
                            rng=seeded_generator([9], "cpu"))
        got_pop, got_zs = eng.pbt_step(tile, [z[bsl] for z in zs[gsl]],
                                       use_greedy=greedy)
        out[f"pbt_{greedy}"] = (
            torch.equal(got_pop.temperature, want_pop.temperature[gsl, bsl])
            and torch.equal(got_pop.best_latency,
                            want_pop.best_latency[gsl, bsl])
            and torch.equal(got_pop.best_fine, want_pop.best_fine[gsl, bsl])
            and all(torch.equal(a, b[bsl])
                    for a, b in zip(got_zs, want_zs[gsl])))
        full_view = eng.gather_population(got_pop)
        out[f"gather_{greedy}"] = (
            torch.equal(full_view.temperature, want_pop.temperature)
            and torch.equal(full_view.best_fine, want_pop.best_fine))
    T = 3
    fines = torch.randint(0, 2, (T, G, B, V), generator=gen)
    lat = np.random.default_rng(2).uniform(1, 2, (T, G, B))
    want = full.update_population(pop, fines, lat)
    got = eng.update_population(pop._replace(
        temperature=pop.temperature[gsl, bsl],
        best_latency=pop.best_latency[gsl, bsl],
        best_fine=pop.best_fine[gsl, bsl]), fines, lat)
    out["update"] = (torch.equal(got.best_latency,
                                 want.best_latency[gsl, bsl])
                     and torch.equal(got.best_fine,
                                     want.best_fine[gsl, bsl]))
    # the window gradient: the tile's loss over the grid's G·B, summed over
    # the mesh, is the whole grid's mean gradient up to float32 rounding
    zs0 = full.initial_state(B)
    _, records, _, _ = full.rollout_window(
        zs0, num_steps=T, start_first=True,
        streams=loop.make_chain_streams(6, G, B, "cpu"))
    weights = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (T, G, B)).astype(np.float32))
    want = full.window_grads(zs0, records, weights, start_first=True)

    def tile_of(rec):
        return type(rec)(*(None if x is None else
                           x[bsl] if x.dim() == 1 else x[:, bsl]
                           for x in rec))
    got = eng.window_grads([z[bsl] for z in zs0[gsl]],
                           [tile_of(r) for r in records[gsl]], weights,
                           start_first=True)
    out["grads_rel_err"] = max(
        float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        for a, b in zip(got, want))
    # window weights on the mesh: within 1e-6 of the 1×1 engine's and of
    # the host float64 path at the reference's tolerance
    rewards = (np.random.default_rng(4).standard_normal((5, G, B))
               .astype(np.float32))
    kw = dict(gamma=0.97, reward_to_go=True, normalize=True,
              reward_norm="pergraph")
    w = eng.window_weights(torch.from_numpy(rewards), **kw).numpy()
    one = ShardedRolloutEngine(engines, num_nodes=full.num_nodes,
                               mesh=LocalMesh()).window_weights(
        torch.from_numpy(rewards), **kw).numpy()
    host = window_weights(rewards.astype(np.float64), HSDAGConfig(
        reward_to_go=True, normalize_weights=True, gamma=0.97),
        reward_norm="pergraph")
    out["weights_vs_1x1"] = float(np.abs(w - one).max())
    out["weights_vs_host"] = bool(np.allclose(w, host, atol=1e-5,
                                              rtol=1e-4))
    return out


#: the reference's corpus run on a 1×2 mesh of two virtual XLA devices:
#: its first window and every window's draws (rebuilt as the port's
#: ``WindowNoise`` by ``test_torch_multi_graph._padded_noise``), its
#: sampled slots and final params, written to one .npz
REF_1X2 = """
    import json, os, sys
    import jax
    import numpy as np
    from repro.core import HSDAGConfig, paper_platform
    from repro.core.sim import sharded
    from repro.core.train.curriculum import CurriculumTrainer
    from repro.graphs import build_corpus
    from test_torch_multi_graph import _padded_noise

    cfg_kw, spec, trainer_kw, out = json.loads(sys.argv[1])
    assert jax.device_count() == 2
    seen, roll = [], sharded.ShardedRolloutEngine.rollout_window

    def spy(self, ops, *a, **k):
        o = roll(self, ops, *a, **k)
        seen.append((ops, o))
        return o

    sharded.ShardedRolloutEngine.rollout_window = spy
    cfg = HSDAGConfig(**cfg_kw)
    res = CurriculumTrainer(cfg, mesh_shape=(1, 2), **trainer_kw
                            ).train_corpus(build_corpus(spec),
                                           platform=paper_platform())
    arrays = {"graphs": np.array(json.dumps(
        [h["graphs"] for h in res.history]))}
    for ep, (ops, o) in enumerate(seen):
        nm = np.asarray(ops.node_mask)
        gb = type("Batch", (), dict(
            max_nodes=nm.shape[1], num_nodes=nm.sum(axis=1),
            num_edges=np.asarray(ops.edge_mask).sum(axis=1),
            edges=np.asarray(ops.edges)))
        keys = np.asarray(o[2])
        for g in range(keys.shape[1]):
            n = _padded_noise(keys[:, g], gb, g, cfg.num_devices,
                              cfg.dropout_network)
            arrays[f"keep_{ep}_{g}"] = n.keep.numpy()
            arrays[f"gumbel_{ep}_{g}"] = n.gumbel.numpy()
    for name, i in (("fines", 3), ("rewards", 5), ("latencies", 6)):
        arrays[name] = np.asarray(seen[0][1][i])
    for i, leaf in enumerate(jax.tree.leaves(res.params)):
        arrays[f"param_{i}"] = np.asarray(leaf)
    np.savez(out + ".part.npz", **arrays)
    os.replace(out + ".part.npz", out)
"""


#: the reference comparison's trainer: one bucket (its slots still differ
#: in size), since the reference compiles each bucket's shapes anew, about
#: 15 s a bucket on the CPU
REF_TRAINER = dict(TRAINER, max_buckets=1)


def _start_reference_1x2(out_dir):
    """The reference's 1×2 run (:data:`REF_1X2`) started in a fresh
    process → (Popen, the .npz it writes)."""
    out = os.path.join(str(out_dir), "ref_1x2.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, TESTS]),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    arg = json.dumps([CFG_KW, SPEC, REF_TRAINER, out])
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_1X2), arg], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out


def _leaves(tree):
    """A params tree's leaves in ``jax.tree.leaves`` order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _against_the_reference(out_dir, timeout: float = 120.0):
    """The port's 1×2 run with ``update="fused"`` (the reference's "auto"
    on a split mesh), each rank's tile drawing the reference's noise,
    against the reference's 1×2 run → the parity facts."""
    path = os.path.join(out_dir, "ref_1x2.npz")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the reference's 1×2 run wrote no {path}")
        time.sleep(0.2)
    ref = np.load(path)
    real = CurriculumTrainer._episode

    def on_reference_draws(self, run, episode, bi, ids, payload,
                           noise=None):
        gsl, bsl = sharded.rollout_tile(run.mesh, len(ids),
                                        CFG_KW["batch_chains"])
        noise = [WindowNoise(
            torch.from_numpy(ref[f"keep_{episode}_{g}"][:, bsl]),
            torch.from_numpy(ref[f"gumbel_{episode}_{g}"][:, bsl]))
            for g in range(len(ids))[gsl]]
        return real(self, run, episode, bi, ids, payload, noise=noise)

    CurriculumTrainer._episode = on_reference_draws
    try:
        res, (fines, rewards, latencies), calls = _train(
            (1, 2), trainer=dict(REF_TRAINER, update="fused"))
    finally:
        CurriculumTrainer._episode = real
    mine = _leaves(params_to_numpy(res.params))
    theirs = [ref[f"param_{i}"] for i in range(len(mine))]
    return {
        "ref_placements_bitwise": all(
            np.array_equal(f, ref["fines"][:, g, :, :f.shape[2]])
            for g, f in enumerate(fines)),
        "ref_rewards_close": bool(np.allclose(rewards, ref["rewards"],
                                              rtol=TOL, atol=0)),
        "ref_latencies_close": bool(np.allclose(
            latencies, ref["latencies"], rtol=TOL, atol=0)),
        "ref_max_param_diff": max(float(np.abs(a - b).max())
                                  for a, b in zip(mine, theirs)),
        "ref_shapes_same": [a.shape for a in mine]
        == [b.shape for b in theirs],
        "ref_history": json.loads(str(ref["graphs"])),
        "history": [h["graphs"] for h in res.history],
        "fused_weights_calls": calls["weights"],
    }


def _rank_1x2(rank, world, out_dir):
    res = _train_pair((1, 2))
    res.update(_pbt_case(make_rollout_mesh(1, 2)))
    # a mesh the group cannot hold, and a resume onto another mesh
    try:
        make_rollout_mesh(2, 2)
        res["world_error"] = ""
    except ValueError as e:
        res["world_error"] = str(e)
    ck = os.path.join(out_dir, "ck")
    _train((1, 2), episodes=1, checkpoint_dir=ck, checkpoint_every=1)
    try:
        _train((2, 1), checkpoint_dir=ck, resume=True)
        res["resume_error"] = ""
    except ValueError as e:
        res["resume_error"] = str(e)
    # last, so that the reference's run has had the most time to finish
    res.update(_against_the_reference(out_dir))
    return res


def _rank_2x2(rank, world, out_dir):
    import repro_torch.checkpoint as ckpt
    res = _train_pair((2, 2))
    pop = _train_pair((2, 2), POP)
    res["pop_first_window_bitwise"] = pop["first_window_bitwise"]
    res["pop_max_param_diff"] = pop["max_param_diff"]
    res["pop_params"] = pop["params"]
    # only rank 0 writes checkpoints and the policy; every rank restores
    saves, save_policy = [], ckpt.save_policy
    ckpt.save_policy = lambda *a, **k: (saves.append(1),
                                        save_policy(*a, **k))
    try:
        trainer = CurriculumTrainer(HSDAGConfig(**CFG_KW), device="cpu",
                                    mesh_shape=(2, 2), **TRAINER)
        trainer.train_corpus(build_corpus(SPEC), platform=paper_platform(),
                             episodes=1, checkpoint_dir=os.path.join(
                                 out_dir, "ck"), checkpoint_every=1)
        trainer.save_policy(os.path.join(out_dir, "policy"))
    finally:
        ckpt.save_policy = save_policy
    res["policy_saves"] = len(saves)
    res["resumed"] = _train((2, 2), checkpoint_dir=os.path.join(
        out_dir, "ck"), resume=True)[0].episodes_run
    return res


def _assert_mesh_parity(results, chain_shards):
    for res in results:
        assert res["first_window_bitwise"], res
        assert res["max_param_diff"] <= 1e-5, res
        assert res["window_weights_calls"] == 0, res   # "auto" → host
    # the "graphs" axis decodes each of the 8 graphs once (a chain shard
    # repeats its row's), however the mesh pads a short chunk
    assert sum(r["greedy_decodes"]
               for r in results[::chain_shards]) == 8, results
    # every rank took the same steps and decisions
    for key in ("params", "best", "greedy"):
        assert len({str(r[key]) for r in results}) == 1, key


def test_two_gloo_ranks_mesh_1x2(tmp_path):
    ref, _ = _start_reference_1x2(tmp_path)
    try:
        results = spawn_ranks("test_torch_sharded", "_rank_1x2", 2,
                              tmp_path)
    finally:
        _, err = ref.communicate(timeout=150)
    assert ref.returncode == 0, err[-3000:]
    _assert_mesh_parity(results, 2)
    for res in results:
        for key in ("pbt_False", "pbt_True", "gather_False", "gather_True",
                    "update", "weights_vs_host", "ref_placements_bitwise",
                    "ref_rewards_close", "ref_latencies_close",
                    "ref_shapes_same"):
            assert res[key] is True, (key, res)
        assert res["weights_vs_1x1"] <= 1e-6, res
        assert res["grads_rel_err"] <= 1e-5, res
        assert res["history"] == res["ref_history"], res
        assert res["ref_max_param_diff"] <= 1e-5, res
        assert res["fused_weights_calls"] > 0, res
        assert "needs 4 processes but the process group has 2" in \
            res["world_error"] and "torchrun" in res["world_error"], res
        assert "mesh=[1, 2]" in res["resume_error"] \
            and "mesh=[2, 1]" in res["resume_error"], res


def test_four_gloo_ranks_mesh_2x2(tmp_path):
    results = spawn_ranks("test_torch_sharded", "_rank_2x2", 4, tmp_path)
    _assert_mesh_parity(results, 2)
    assert [r["policy_saves"] for r in results] == [1, 0, 0, 0]
    for res in results:
        assert res["pop_first_window_bitwise"], res
        assert res["pop_max_param_diff"] <= 1e-5, res
        assert res["resumed"] == CFG_KW["max_episodes"] - 1, res
    assert len({r["pop_params"] for r in results}) == 1
    assert sorted(os.listdir(tmp_path / "policy")) == ["step_0000000000"]
