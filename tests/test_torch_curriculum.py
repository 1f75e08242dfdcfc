"""Port parity, the corpus curriculum trainer: the sampler's draws and state
(three strategies), the episodic population controller, the prefetcher,
one corpus episode (a repeated slot in a padded bucket) and its update
against the reference's own padded draws, the corpus greedy decodes with
the same weights, each package's corpus checkpoint resumed by the other,
and the port's own runs: resume bit for bit (with and without the EMA
baseline, with the episodic population), streaming equal to eager,
``prefetch="on"`` equal to ``"off"``, warm starts and the validations."""
import functools
import gc
import json
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.core import HSDAG as RefHSDAG  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.core import paper_platform as ref_paper  # noqa: E402
from repro.core.sim import rollout as refrollout  # noqa: E402
from repro.core.train import loop as refloop  # noqa: E402
from repro.core.train import population as refpop  # noqa: E402
from repro.core.train import sampler as refsampler  # noqa: E402
from repro.core.train.curriculum import \
    CurriculumTrainer as RefTrainer  # noqa: E402
from repro.graphs import workloads as refwl  # noqa: E402

from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    params_to_numpy, tree_from_tensors)
from repro_torch.core import (HSDAGConfig, paper_platform,  # noqa: E402
                              simulate)
from repro_torch.core.sim import rollout as portrollout  # noqa: E402
from repro_torch.core.train import (CurriculumSampler,  # noqa: E402
                                    CurriculumTrainer, EpisodePrefetcher,
                                    PopulationConfig, PopulationController)
from repro_torch.graphs import build_corpus  # noqa: E402

from test_torch_hsdag import TOL, _assert_trees_close  # noqa: E402
from test_torch_grad_precision import F32_RTOL  # noqa: E402
from test_torch_multi_graph import _padded_noise  # noqa: E402

#: four synthetic graphs of 8-18 nodes; with two buckets of three slots,
#: seed 2's first episode draws graph 0 (12 nodes, its bucket's largest)
#: once and graph 2 (8 nodes, padded to 12 in the reference) twice
SPEC = "synthetic:family=layered+series_parallel:count=4:size=12:seed=7"
TRAINER = {"max_buckets": 2, "graphs_per_episode": 3}
CFG = dict(num_devices=2, hidden_channel=32, batch_chains=2,
           update_timestep=3, max_episodes=2, seed=2)


def _cfg(**kw):
    return HSDAGConfig(**dict(CFG, **kw))


def _trainer(**kw):
    cfg = kw.pop("cfg", _cfg())
    return CurriculumTrainer(cfg, device="cpu", **dict(TRAINER, **kw))


# ------------------------------------------------------------------ sampler
@pytest.mark.parametrize("strategy", ["uniform", "stratified", "plateau"])
def test_sampler_draws_and_state_match_the_reference(strategy):
    """The same (bucket, ids) sequence for one seed, fed the same bests;
    ``peek`` predicts the draw; the state crosses packages as JSON."""
    buckets = [[4, 1, 7], [0, 2], [3, 5, 6, 8]]
    kw = dict(graphs_per_episode=3, strategy=strategy, seed=5,
              plateau_patience=2)
    mine = CurriculumSampler(buckets, **kw)
    ref = refsampler.CurriculumSampler(buckets, **kw)
    rng = np.random.default_rng(0)
    best = np.full(9, np.inf)
    for step in range(12):
        assert mine.peek() == ref.peek()
        got = mine.sample()
        assert got == ref.sample()
        # improve some sampled graphs, leave others stale
        for i in got[1][:1 + step % 2]:
            best[i] = min(best[i], rng.uniform(1, 2))
        mine.observe(got[1], best)
        ref.observe(got[1], best)
    state = json.loads(json.dumps(mine.state_dict()))
    assert state == json.loads(json.dumps(ref.state_dict()))
    crossed = refsampler.CurriculumSampler(buckets, **kw)
    crossed.load_state_dict(state)
    again = CurriculumSampler(buckets, **kw)
    again.load_state_dict(json.loads(json.dumps(ref.state_dict())))
    for _ in range(5):
        want = ref.sample()
        assert crossed.sample() == want == again.sample()
    with pytest.raises(ValueError, match="bucket partition"):
        CurriculumSampler([[0, 1, 2, 3, 4, 5, 6, 7, 8]], **kw) \
            .load_state_dict(state)
    for bad in (dict(strategy="bogus"), dict(graphs_per_episode=0)):
        with pytest.raises(ValueError):
            CurriculumSampler(buckets, **dict(kw, **bad))
    with pytest.raises(ValueError):
        CurriculumSampler([[0], []], **kw)


# ------------------------------------------------------ episodic population
def test_episodic_controller_matches_the_reference():
    """Temperatures, culls, the rng's bit state and the whole state dict
    over a fed sequence of (T, G, B) latencies."""
    cfg = refpop.PopulationConfig(cull_every=2, cull_fraction=0.3,
                                  elite_fraction=0.3, seed=4)
    ref = refpop.PopulationController(cfg, num_chains=8, in_jit_pbt=False)
    mine = PopulationController(PopulationConfig.from_json(cfg.to_json()),
                                num_chains=8, in_jit_pbt=False)
    np.testing.assert_array_equal(mine.temps, ref.temps)
    assert mine.temps.dtype == np.float32
    rng = np.random.default_rng(1)
    for episode in range(7):
        lat = rng.uniform(1e-3, 2e-3, (3, 1 + episode % 3, 8))
        assert mine.observe_episode(lat) == ref.observe_episode(lat)
        np.testing.assert_array_equal(mine.temps, ref.temps)
    assert mine.summary() == ref.summary() and mine.rounds == 3
    state = json.loads(json.dumps(mine.state_dict()))
    assert state == json.loads(json.dumps(ref.state_dict()))
    again = PopulationController(mine.cfg, num_chains=8, in_jit_pbt=False)
    again.load_state_dict(json.loads(json.dumps(ref.state_dict())))
    lat = rng.uniform(1e-3, 2e-3, (3, 2, 8))
    for ctl in (again, ref):
        ctl.observe_episode(lat)
    np.testing.assert_array_equal(again.temps, ref.temps)
    with pytest.raises(RuntimeError, match="episodic"):
        PopulationController(mine.cfg, num_chains=8).observe_episode(lat)


# --------------------------------------------------------------- prefetcher
def test_prefetcher_hits_misses_errors_and_close():
    built = []

    def build(bi, ids):
        built.append((bi, ids))
        if bi < 0:
            raise KeyError("bad bucket")
        return bi * 100 + sum(ids)

    pf = EpisodePrefetcher(build)
    assert pf.alive
    pf.schedule((1, (2, 3)))
    pf.schedule((9, (9,)))                 # one in flight: ignored
    assert pf.get((1, (2, 3)))[0] == 105
    pf.schedule((2, (0,)))
    payload, wait = pf.get((2, (1,)))      # mispredicted: built again
    assert payload == 201 and wait >= 0
    assert (pf.hits, pf.misses) == (1, 1)
    assert pf.get((0, (4,)))[0] == 4       # nothing scheduled: built here
    pf.schedule((-1, ()))
    with pytest.raises(KeyError, match="bad bucket"):
        pf.get((-1, ()))
    pf.schedule((3, (1,)))                 # closing with a build in flight
    pf.close()
    pf.close()
    assert not pf.alive
    assert built[:3] == [(1, (2, 3)), (2, (0,)), (2, (1,))]


# ------------------------------------------- one episode against the reference
@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's corpus run (two episodes, one a bucket, a checkpoint
    after each), with the first episode's rollout, its replay weights and
    gradient and the weights before and after it captured."""
    graphs = refwl.build_corpus(SPEC)
    cfg = RefConfig(**CFG)
    seen = {"rollout": [], "grads": []}
    real_roll = refrollout.DynamicRolloutEngine.rollout_window
    real_grads = refrollout.DynamicRolloutEngine.window_grads

    def roll(self, ops, params, z, rngs, **kw):
        out = real_roll(self, ops, params, z, rngs, **kw)
        seen["rollout"].append((ops, params, out))
        return out

    def grads(self, ops, params, z0, keys, weights, **kw):
        out = real_grads(self, ops, params, z0, keys, weights, **kw)
        seen["grads"].append((np.asarray(weights), out))
        return out

    ckpt = str(tmp_path_factory.mktemp("ref_corpus"))
    refrollout.DynamicRolloutEngine.rollout_window = roll
    refrollout.DynamicRolloutEngine.window_grads = grads
    try:
        trainer = RefTrainer(cfg, prefetch="off", **TRAINER)
        res = trainer.train_corpus(graphs, platform=ref_paper(),
                                   checkpoint_dir=ckpt, checkpoint_every=1)
    finally:
        refrollout.DynamicRolloutEngine.rollout_window = real_roll
        refrollout.DynamicRolloutEngine.window_grads = real_grads
    return dict(graphs=graphs, cfg=cfg, res=res, seen=seen, ckpt=ckpt,
                trainer=trainer)


def _labels_actions(cfg, params, ops, keys):
    """Each slot's labels and coarse actions, replayed step by step with the
    reference's own padded, masked step → (G, T, B, V_max) each."""
    step = jax.jit(functools.partial(RefHSDAG(cfg)._step, train=True),
                   static_argnames=("first",))
    T, G, B = keys.shape[:3]
    vm = ops.x0.shape[1]
    labels = np.zeros((G, T, B, vm), np.int64)
    actions = np.zeros_like(labels)
    for g in range(G):
        x0, adj, edges, nm, em = (a[g] for a in (
            ops.x0, ops.adj, ops.edges, ops.node_mask, ops.edge_mask))
        for b in range(B):
            z = x0
            for t in range(T):
                o = step(params, z, x0, adj, edges, jnp.asarray(keys[t, g, b]),
                         first=t == 0, node_mask=nm, edge_mask=em)
                labels[g, t, b] = np.asarray(o.parse.labels)
                actions[g, t, b] = np.asarray(o.policy.coarse_placement)
                z = o.z_next
    return labels, actions


def test_a_corpus_episode_matches_the_reference(ref_run):
    """Episode 0 (bucket 0, a repeated slot padded to the bucket's width)
    on the reference's own draws: the weights it starts from, the sampled
    slots, labels, actions and placements exact, rewards and latencies at
    1e-5, the Eq.-14 gradient, the update and the tracked bests."""
    ops, params0, out = ref_run["seen"]["rollout"][0]
    fines_ref, rewards_ref, lat_ref = (np.asarray(out[i]) for i in (3, 5, 6))
    keys = np.asarray(out[2])
    hist = ref_run["res"].history[0]
    nm = np.asarray(ops.node_mask)
    sizes = nm.sum(axis=1)
    assert len(set(hist["graphs"])) < len(hist["graphs"])     # a repeat
    assert sizes.min() < nm.shape[1]                          # padding

    trainer = _trainer()
    graphs = build_corpus(SPEC)
    run = trainer._start(graphs, paper_platform(), None)
    for a, b in zip(jax.tree.leaves(params_to_numpy(trainer.policy)),
                    jax.tree.leaves(jax.tree.map(np.asarray, params0))):
        np.testing.assert_array_equal(a, b)
    bi, ids = run.sampler.sample()
    assert bi == hist["bucket"] == 0
    assert [graphs[i].name for i in ids] == hist["graphs"]

    gb = type("Batch", (), dict(
        max_nodes=nm.shape[1], num_nodes=sizes,
        num_edges=np.asarray(ops.edge_mask).sum(axis=1),
        edges=np.asarray(ops.edges)))
    noise = [_padded_noise(keys[:, g], gb, g, 2) for g in range(len(ids))]
    caught = {}
    real_roll = portrollout.MultiRolloutEngine.rollout_window
    real_apply = trainer.apply_grads

    def roll(self, *a, **kw):
        caught["rollout"] = real_roll(self, *a, **kw)
        return caught["rollout"]

    def apply(grads):
        caught["grads"] = grads
        real_apply(grads)
    portrollout.MultiRolloutEngine.rollout_window = roll
    trainer.apply_grads = apply
    try:
        stats = trainer._episode(run, 0, bi, ids, run.build(ids),
                                 noise=noise)
    finally:
        portrollout.MultiRolloutEngine.rollout_window = real_roll

    labels, actions = _labels_actions(ref_run["cfg"], params0, ops, keys)
    _, records, fines, ngroups = caught["rollout"]
    for g in range(len(ids)):
        n = int(sizes[g])
        np.testing.assert_array_equal(records[g].labels.numpy(),
                                      labels[g][..., :n])
        np.testing.assert_array_equal(records[g].actions.numpy(),
                                      actions[g][..., :n])
        np.testing.assert_array_equal(fines[g].numpy(),
                                      fines_ref[:, g, :, :n])
    np.testing.assert_array_equal(ngroups.numpy(), np.asarray(out[4]))
    assert stats["mean_reward"] == pytest.approx(float(rewards_ref.mean()),
                                                 rel=TOL)
    assert stats["mean_groups"] == hist["mean_groups"]

    names = [n for n, _ in trainer.policy.named_parameters()]
    ref_w, ref_grads = ref_run["seen"]["grads"][0]
    _assert_trees_close(tree_from_tensors(names, caught["grads"]),
                        jax.tree.map(np.asarray, ref_grads), F32_RTOL,
                        "corpus window gradient")
    params1 = ref_run["seen"]["rollout"][1][1]
    for a, b in zip(jax.tree.leaves(params_to_numpy(trainer.policy)),
                    jax.tree.leaves(jax.tree.map(np.asarray, params1))):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    for gid in set(ids):
        want = lat_ref[:, [k for k, i in enumerate(ids) if i == gid]].min()
        assert run.tracker.best_latencies[gid] == pytest.approx(want,
                                                                rel=TOL)
        assert simulate(graphs[gid], run.tracker.best_placements[gid],
                        paper_platform()).latency == pytest.approx(
            run.tracker.best_latencies[gid], rel=TOL)
    assert stats["per_graph_best"][ids[0]] == pytest.approx(
        hist["per_graph_best"][ids[0]], rel=TOL)


def test_corpus_greedy_decodes_and_checkpoint_match_the_reference(ref_run):
    """The port resumes the reference's finished corpus checkpoint: its
    weights, optimizer state and tracker land bitwise, and its greedy
    decodes with those weights are the reference's placements."""
    res = ref_run["res"]
    ckpt = ref_run["ckpt"]
    ref_mgr = RefManager(ckpt)
    last = ref_mgr.latest_step()
    assert last == 1
    trainer = _trainer()
    graphs = build_corpus(SPEC)
    got = trainer.train_corpus(graphs, platform=paper_platform(),
                               checkpoint_dir=ckpt, resume=True)
    assert got.episodes_run == 0 and got.history == []
    for a, b in zip(jax.tree.leaves(params_to_numpy(trainer.policy)),
                    jax.tree.leaves(jax.tree.map(np.asarray, res.params))):
        np.testing.assert_array_equal(a, b)
    names = [n for n, _ in trainer.policy.named_parameters()]
    opt = trainer._opt.state_tree(names)
    ref_state = ref_mgr.restore(last, {
        "params": ref_run["trainer"].params,
        "opt": ref_run["trainer"]._opt_state})
    assert int(opt["step"]) == int(ref_state["opt"].step) == 2
    for key in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(opt[key]), jax.tree.leaves(
                jax.tree.map(np.asarray, getattr(ref_state["opt"], key)))):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.best_latencies, res.best_latencies)
    for a, b in zip(got.best_placements, res.best_placements):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.greedy_placements, res.greedy_placements):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.greedy_latencies, res.greedy_latencies,
                               rtol=1e-12)


def test_the_reference_resumes_the_ports_corpus_checkpoint(tmp_path):
    """The port's corpus checkpoint read by the reference: its manager's
    restore, the manifest's records (sampler, tracker, population, EMA
    baseline) in the reference's objects, and the state bitwise."""
    trainer = _trainer(cfg=_cfg(use_baseline=True), reward_norm="none",
                       population={"cull_every": 1})
    res = trainer.train_corpus(build_corpus(SPEC), platform=paper_platform(),
                               checkpoint_dir=str(tmp_path),
                               checkpoint_every=1)
    mgr = RefManager(str(tmp_path))
    assert mgr.all_steps() == [0, 1]
    man = mgr.manifest(1)
    assert {"episode", "corpus_fingerprint", "sampler", "tracker",
            "engine", "feature_config", "mesh", "stream", "baseline",
            "population", "step", "time"} == set(man)
    assert man["episode"] == 1 and man["mesh"] is None \
        and man["stream"] is False
    assert man["corpus_fingerprint"] == refwl.corpus_fingerprint(
        refwl.build_corpus(SPEC))
    ref = RefHSDAG(RefConfig(**CFG))
    params_like = jax.tree.map(jnp.asarray, params_to_numpy(trainer.policy))
    state = mgr.restore(1, {"params": params_like,
                            "opt": ref._opt.init(params_like)})
    for a, b in zip(jax.tree.leaves(params_to_numpy(trainer.policy)),
                    jax.tree.leaves(state["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    names = [n for n, _ in trainer.policy.named_parameters()]
    opt = trainer._opt.state_tree(names)
    assert int(state["opt"].step) == int(opt["step"]) == 2
    for a, b in zip(jax.tree.leaves(opt["mu"]),
                    jax.tree.leaves(state["opt"].mu)):
        np.testing.assert_array_equal(a, np.asarray(b))
    sampler = refsampler.CurriculumSampler(
        man["sampler"]["buckets"], graphs_per_episode=3, seed=CFG["seed"])
    sampler.load_state_dict(man["sampler"])
    tracker = refloop.BestTracker([len(p) for p in res.best_placements], 2)
    tracker.load_state_arrays({k: np.asarray(v)
                               for k, v in man["tracker"].items()})
    np.testing.assert_array_equal(tracker.best_latencies,
                                  res.best_latencies)
    ctl = refpop.PopulationController(
        refpop.PopulationConfig(cull_every=1), num_chains=2,
        in_jit_pbt=False)
    ctl.load_state_dict(man["population"])
    assert ctl.windows_seen == 2 and ctl.rounds == 2
    assert np.isfinite(man["baseline"]["value"]) \
        and man["baseline"]["beta"] == 0.9


# ------------------------------------------------------- the port's own runs
def _same_run(a, b):
    assert [h["graphs"] for h in a.history] == \
        [h["graphs"] for h in b.history]
    for key in ("mean_reward", "best_latency", "per_graph_best",
                "mean_groups"):
        assert [h[key] for h in a.history] == [h[key] for h in b.history]
    np.testing.assert_array_equal(a.best_latencies, b.best_latencies)
    for x, y in zip(a.best_placements + a.greedy_placements,
                    b.best_placements + b.greedy_placements):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("setup", ["pergraph", "ema+population"])
def test_resume_is_bit_for_bit(tmp_path, setup):
    """Four episodes straight against two, a checkpoint, and a fresh
    trainer resuming to four: the same graphs, stats, bests, decodes and
    weights, bitwise (the EMA baseline and the episodic population
    restored too)."""
    kw = ({} if setup == "pergraph" else
          dict(cfg=_cfg(use_baseline=True, max_episodes=4),
               reward_norm="none", population={"cull_every": 1}))
    kw.setdefault("cfg", _cfg(max_episodes=4))
    graphs = build_corpus(SPEC)
    plat = paper_platform()
    straight = _trainer(**kw).train_corpus(graphs, platform=plat)
    first = _trainer(**kw).train_corpus(
        graphs, platform=plat, episodes=2, checkpoint_dir=str(tmp_path),
        checkpoint_every=1)
    assert first.episodes_run == 2
    rest = _trainer(**kw).train_corpus(
        graphs, platform=plat, checkpoint_dir=str(tmp_path), resume=True)
    assert rest.episodes_run == 2
    assert [h["episode"] for h in rest.history] == [2, 3]
    rest = rest._replace(history=first.history + rest.history)
    _same_run(straight, rest)
    if setup != "pergraph":
        assert all("culled" in h for h in straight.history)
        assert [h["temp_mean"] for h in straight.history] == \
            [h["temp_mean"] for h in rest.history]


def test_streaming_and_prefetch_are_the_eager_run_bit_for_bit():
    """A streaming corpus (one graph cached at a time) and a prefetching
    run draw what the eager, synchronous run draws, bitwise; the streaming
    run's caches hold at most ``stream_cache`` graphs and release the
    graphs they evict."""
    plat = paper_platform()
    cfg = _cfg(max_episodes=4)
    eager = _trainer(cfg=cfg, prefetch="off")
    want = eager.train_corpus(build_corpus(SPEC), platform=plat)
    assert eager.prefetch_stats == {"hits": 0, "misses": 0}
    on = _trainer(cfg=cfg, prefetch="on")
    _same_run(want, on.train_corpus(build_corpus(SPEC), platform=plat))
    assert on.prefetch_stats == {"hits": 3, "misses": 0}

    corpus = build_corpus("stream:" + SPEC, cache_graphs=1)
    built = []
    real = corpus._thunks

    def tracked(i):
        def thunk():
            g = real[i]()
            built.append(weakref.ref(g))
            return g
        return thunk
    corpus._thunks = [tracked(i) for i in range(len(real))]
    streamed = _trainer(cfg=cfg, stream_cache=1, prefetch="on")
    got = streamed.train_corpus(corpus, platform=plat)
    _same_run(want, got)
    assert streamed.cache_peaks == {"host": 1, "device": 1}
    assert len(corpus.cached_indices()) == 1
    del got
    gc.collect()
    alive = [r for r in built if r() is not None]
    assert len(built) > len(corpus) and len(alive) <= 2


def test_warm_start_and_its_vocabulary_check(tmp_path):
    from repro_torch.graphs import resnet50
    plat = paper_platform()
    src = _trainer()
    src.train_corpus(build_corpus(SPEC), platform=plat)
    src.save_policy(str(tmp_path))
    held = build_corpus("synthetic:family=branch_join:count=1:size=14:seed=3")
    warm = _trainer(max_buckets=1, graphs_per_episode=1)
    warm.warm_start(str(tmp_path))
    res = warm.train_corpus(held, platform=plat, episodes=0)
    assert res.episodes_run == 0
    assert warm.feature_config == src.feature_config
    for a, b in zip(warm.policy.parameters(), src.policy.parameters()):
        assert torch.equal(a, b)
    p, lat = src.evaluate_zero_shot(held[0], platform=plat)
    np.testing.assert_array_equal(res.greedy_placements[0], p)
    assert res.greedy_latencies[0] == lat
    warm.warm_start(str(tmp_path))
    res = warm.train_corpus(held, platform=plat, episodes=2)
    assert res.episodes_run == 2 and np.isfinite(res.best_latencies).all()
    other = _trainer()
    other.warm_start(str(tmp_path))
    with pytest.raises(ValueError, match="AvgPool"):
        other.train_corpus([resnet50()], platform=plat)
    bare = tmp_path / "bare"
    CheckpointManager(str(bare)).save(0, params_to_numpy(src.policy), {})
    with pytest.raises(ValueError, match="feature_config"):
        _trainer().warm_start(str(bare))


def test_validations(tmp_path):
    graphs = build_corpus(SPEC)
    plat = paper_platform()
    for kw, err, match in (
            (dict(cfg=_cfg(engine="scalar")), ValueError, "scalar"),
            (dict(max_buckets=0), ValueError, "max_buckets"),
            (dict(update="bogus"), ValueError, "update mode"),
            (dict(prefetch="bogus"), ValueError, "prefetch mode"),
            (dict(mesh_shape=(0, 1)), ValueError, "positive"),
            (dict(stream_cache=0), ValueError, "stream_cache"),
            (dict(population=3), TypeError, "PopulationConfig")):
        with pytest.raises(err, match=match):
            _trainer(**kw)
    for kw, match in (
            (dict(update="fused", cfg=_cfg(use_baseline=True),
                  reward_norm="none"), "EMA baseline"),
            (dict(update="fused", cfg=_cfg(engine="level")), "host-side"),
            (dict(mesh_shape=(2, 1)), "does not tile the mesh 'graphs'")):
        with pytest.raises(ValueError, match=match):
            _trainer(**kw).train_corpus(graphs, platform=plat)
    for update in ("auto", "host", "fused"):
        assert _trainer(update=update).update == update
    with pytest.raises(ValueError, match="at least one graph"):
        _trainer().train_corpus([], platform=plat)
    with pytest.raises(ValueError, match="exceeds"):
        _trainer(cfg=_cfg(num_devices=3)).train_corpus(graphs,
                                                       platform=plat)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _trainer().train_corpus(graphs, platform=plat, resume=True)
    _trainer().train_corpus(graphs, platform=plat, episodes=1,
                            checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="fingerprint"):
        _trainer().train_corpus(graphs[:3], platform=plat,
                                checkpoint_dir=str(tmp_path), resume=True)
    with pytest.raises(ValueError, match="population"):
        _trainer(population={"cull_every": 1}).train_corpus(
            graphs, platform=plat, checkpoint_dir=str(tmp_path),
            resume=True)
    with pytest.raises(ValueError, match="EMA-baseline"):
        _trainer(cfg=_cfg(use_baseline=True), reward_norm="none") \
            .train_corpus(graphs, platform=plat,
                          checkpoint_dir=str(tmp_path), resume=True)
    # an empty directory resumes nothing and trains from episode 0
    res = _trainer().train_corpus(graphs, platform=plat, episodes=1,
                                  checkpoint_dir=str(tmp_path / "empty"),
                                  resume=True)
    assert res.episodes_run == 1
