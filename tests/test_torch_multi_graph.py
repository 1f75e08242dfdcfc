"""Port parity, joint multi-graph training: the padded host layer, the
backends' ``simulate_multi``, one (G=3, B=2) window of ``train_multi`` and
its update against the reference's on the reference's own draws (both
reward norms, and a population round over the G rows), the one-graph run
against the port's ``search`` bit for bit, the device head's capacity mask,
zero-shot transfer and the reference's validations."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HSDAG as RefHSDAG  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.core import costmodel as refcm  # noqa: E402
from repro.core import features as reffeat  # noqa: E402
from repro.core import paper_platform as ref_paper  # noqa: E402
from repro.core.reinforce import RunningBaseline as RefBaseline  # noqa: E402
from repro.core.reinforce import step_weights  # noqa: E402
from repro.core.sim import RewardPipeline as RefPipeline  # noqa: E402
from repro.core.sim import get_backend as ref_backend  # noqa: E402
from repro.core.train import loop as refloop  # noqa: E402
from repro.core.train import population as refpop  # noqa: E402
from repro.graphs import PAPER_BENCHMARKS as REF_GRAPHS  # noqa: E402

from repro_torch.checkpoint import (params_to_numpy,  # noqa: E402
                                    tree_from_tensors)
from repro_torch.core import (HSDAG, FeatureConfig, HSDAGConfig,  # noqa: E402
                              MultiGraphTrainer, batch_graph_arrays,
                              extract_features, get_backend, paper_platform,
                              simulate)
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core import features as feat  # noqa: E402
from repro_torch.core.sim import WindowNoise  # noqa: E402
from repro_torch.core.train import (PopulationConfig,  # noqa: E402
                                    window_weights)

from conftest import make_diamond, random_dag  # noqa: E402
from test_torch_grad_precision import F32_RTOL  # noqa: E402
from test_torch_hsdag import GRAD_RTOL, TOL, _assert_trees_close  # noqa: E402

B, T, HIDDEN = 2, 3, 16
#: the joint window's three graphs: (nodes, edge probability)
SIZES = ((9, 0.3), (16, 0.2), (12, 0.25))


def _graphs():
    rng = np.random.default_rng(11)
    return [random_dag(rng, n, p) for n, p in SIZES]


# ---------------------------------------------------------------- host layer
def _assert_sim_arrays_equal(mine, want):
    for f in want._fields:
        a, b = getattr(mine, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_padded_sim_arrays_match_the_reference():
    graphs = _graphs() + [make_diamond()]
    plat, ref_plat = paper_platform(), ref_paper()
    for g in graphs:
        sa, ref_sa = cm.sim_arrays(g, plat), refcm.sim_arrays(g, ref_plat)
        n, p = sa.num_nodes, sa.preds.shape[1]
        assert cm.pad_sim_arrays(sa, n) is sa
        for v_max, p_max in ((n + 5, None), (n + 40, p + 3), (n, p + 1)):
            _assert_sim_arrays_equal(
                cm.pad_sim_arrays(sa, v_max, p_max),
                refcm.pad_sim_arrays(ref_sa, v_max, p_max))
        with pytest.raises(ValueError):
            cm.pad_sim_arrays(sa, n - 1)
    for kw in ({}, {"v_max": 30, "p_max": 9}, {"schedule": "level"}):
        mine = cm.sim_arrays_batch(graphs, plat, **kw)
        want = refcm.sim_arrays_batch(graphs, ref_plat, **kw)
        _assert_sim_arrays_equal(mine.arrays, want.arrays)
        np.testing.assert_array_equal(mine.node_mask, want.node_mask)
        np.testing.assert_array_equal(mine.num_nodes, want.num_nodes)
        assert (mine.num_graphs, mine.max_nodes, mine.num_devices) == \
            (want.num_graphs, want.max_nodes, want.num_devices)
    for kw in ({"v_max": 3}, {"p_max": 0}):
        with pytest.raises(ValueError):
            cm.sim_arrays_batch(graphs, plat, **kw)
    with pytest.raises(ValueError):
        cm.sim_arrays_batch([], plat)


def test_buckets_match_the_reference():
    rng = np.random.default_rng(3)
    graphs = [random_dag(rng, n, 0.2) for n in (5, 40, 7, 22, 6, 41, 23)]
    sizes = [g.num_nodes for g in graphs]
    for k in (1, 2, 3, 7, 9):
        assert cm.plan_buckets(sizes, k) == refcm.plan_buckets(sizes, k)
    assert cm.plan_buckets([], 2) == [] and cm.plan_buckets([4, 4, 4], 2) \
        == refcm.plan_buckets([4, 4, 4], 2)
    with pytest.raises(ValueError):
        cm.plan_buckets(sizes, 0)
    fc = feat.shared_feature_config(graphs, FeatureConfig(d_pos=8))
    ref_fc = reffeat.shared_feature_config(graphs,
                                           reffeat.FeatureConfig(d_pos=8))
    arrays = [extract_features(g, fc) for g in graphs]
    ref_arrays = [reffeat.extract_features(g, ref_fc) for g in graphs]
    for kw in ({"max_buckets": 3}, {"max_buckets": 1,
                                    "buckets": [[6, 0], [2, 1, 3, 4, 5]]}):
        bk, batches = cm.sim_arrays_bucketed(graphs, paper_platform(), **kw)
        ref_bk, ref_batches = refcm.sim_arrays_bucketed(graphs, ref_paper(),
                                                        **kw)
        assert [list(b) for b in bk] == [list(b) for b in ref_bk]
        for mine, want in zip(batches, ref_batches):
            _assert_sim_arrays_equal(mine.arrays, want.arrays)
            np.testing.assert_array_equal(mine.node_mask, want.node_mask)
        bk, batches = feat.batch_graph_arrays_bucketed(arrays, **kw)
        ref_bk, ref_batches = reffeat.batch_graph_arrays_bucketed(ref_arrays,
                                                                  **kw)
        assert bk == ref_bk
        for mine, want in zip(batches, ref_batches):
            for f in ("x", "adj", "edges", "node_mask", "edge_mask",
                      "num_nodes", "num_edges"):
                np.testing.assert_array_equal(getattr(mine, f),
                                              getattr(want, f), err_msg=f)


@pytest.mark.parametrize("name", ["diamond", "random", *sorted(REF_GRAPHS)])
def test_critical_path_matches_the_reference(name):
    g = (make_diamond() if name == "diamond" else
         random_dag(np.random.default_rng(5), 30, 0.15) if name == "random"
         else REF_GRAPHS[name]())
    got = cm.critical_path(g, paper_platform())
    assert got == refcm.critical_path(g, ref_paper()) and got > 0


def test_shared_feature_config_and_its_check_match_the_reference():
    graphs = _graphs() + [make_diamond()]
    base = FeatureConfig(d_pos=8)
    fc = feat.shared_feature_config(graphs, base)
    ref_fc = reffeat.shared_feature_config(graphs,
                                           reffeat.FeatureConfig(d_pos=8))
    assert dataclasses.asdict(fc) == dataclasses.asdict(ref_fc)
    for g in graphs:
        np.testing.assert_array_equal(
            extract_features(g, fc).x, reffeat.extract_features(g, ref_fc).x)
    feat.check_feature_compat(fc, graphs)
    narrow = feat.shared_feature_config([make_diamond()], base)
    ref_narrow = reffeat.shared_feature_config(
        [make_diamond()], reffeat.FeatureConfig(d_pos=8))
    for cfg, check in ((narrow, feat.check_feature_compat),
                       (ref_narrow, reffeat.check_feature_compat)):
        with pytest.raises(ValueError, match="Convolution") as err:
            check(cfg, graphs)
        assert "rand9" in str(err.value)
    with pytest.raises(ValueError, match="no op_vocab"):
        feat.check_feature_compat(base, graphs)


# ------------------------------------------------------------ simulate_multi
@pytest.mark.parametrize("backend", ["scan", "level", "reference"])
def test_simulate_multi_matches_the_reference(backend):
    """(G, B, V_max) placements of three graphs padded past the largest:
    the port against the reference's ``simulate_multi`` and the host
    scheduler (in the backend's order) at 1e-5; device ids out of range at
    pad columns are ignored, at real ones raise."""
    graphs = _graphs()
    plat, ref_plat = paper_platform(), ref_paper()
    v_max = 20
    rng = np.random.default_rng(4)
    placements = rng.integers(0, 2, (len(graphs), 5, v_max))
    for i, g in enumerate(graphs):
        placements[i, :, g.num_nodes:] = 7       # pad columns: ignored
    mine = get_backend(backend, device="cpu")
    preps = mine.prepare_batch(graphs, plat, v_max=v_max)
    res = mine.simulate_multi(preps, placements)
    ref = ref_backend(backend)
    ref_preps = ref.prepare_batch(graphs, ref_plat, v_max=v_max)
    # The reference's level backend checks pad columns too: give it zeros
    # there (its pad slots are data ops, whatever device they name).
    real = np.arange(v_max)[None] < np.array([g.num_nodes
                                              for g in graphs])[:, None]
    ref_placements = np.where(real[:, None], placements, 0)
    want = ref.simulate_multi(ref_preps, ref_placements)
    assert res.latency.shape == (len(graphs), 5)
    for f in ("latency", "reward", "transfer_time", "per_device_busy"):
        np.testing.assert_allclose(getattr(res, f), getattr(want, f),
                                   rtol=TOL, err_msg=f)
    np.testing.assert_array_equal(res.oom, want.oom)
    for i, (g, prep) in enumerate(zip(graphs, preps)):
        order = mine.schedule_order(prep)
        host = [simulate(g, p[:g.num_nodes], plat, order=order).latency
                for p in placements[i]]
        np.testing.assert_allclose(res.latency[i], host, rtol=TOL)
    if backend != "reference":
        bad = placements.copy()
        bad[1, 2, 0] = 2
        with pytest.raises(ValueError, match="device ids"):
            mine.simulate_multi(preps, bad)
    with pytest.raises(ValueError, match="v_max"):
        mine.prepare_batch(graphs, plat, v_max=15)
    with pytest.raises(ValueError, match="placements"):
        mine.simulate_multi(preps, placements[:2])


def test_a_host_reward_scores_a_joint_window_in_t_g_b_order():
    """A host ``reward_fn`` over a joint window (one (T, B, V_g) array a
    graph) is called in the reference's (t, g, b) order on each graph's
    V_g columns."""
    from repro_torch.core.sim import RewardPipeline
    graphs = _graphs()
    calls = []

    def reward_fn(p):
        calls.append(p.copy())
        return float(p.sum()), float(len(p))
    pipe = RewardPipeline(reward_fn=reward_fn,
                          num_nodes=[g.num_nodes for g in graphs])
    fines = np.random.default_rng(2).integers(0, 2, (2, 3, 2, 20))
    rewards, latencies = pipe.score_window(
        [fines[:, g, :, :graph.num_nodes] for g, graph in enumerate(graphs)])
    want = [fines[t, g, b, :graphs[g].num_nodes] for t in range(2)
            for g in range(3) for b in range(2)]
    assert len(calls) == len(want)
    for got, w in zip(calls, want):
        np.testing.assert_array_equal(got, w)
    assert rewards.shape == latencies.shape == (2, 3, 2)
    np.testing.assert_array_equal(latencies[0, :, 0],
                                  [g.num_nodes for g in graphs])


# ------------------------------------------------------ the (G, B) window
def _padded_noise(keys, gb, g, num_devices, dropout=0.2):
    """Graph g's slot of the reference's padded draws, rebuilt from its
    (T, B) keys: the edge keep-mask at its real edges of a (V_max, V_max)
    draw, and the first V_g rows of the (V_max, D) Gumbel noise."""
    vm, n, e = gb.max_nodes, int(gb.num_nodes[g]), int(gb.num_edges[g])
    src, dst = gb.edges[g, :e, 0], gb.edges[g, :e, 1]
    keep = np.zeros(keys.shape[:2] + (e,), np.float32)
    gumbel = np.zeros(keys.shape[:2] + (n, num_devices), np.float32)
    for t in range(keys.shape[0]):
        for b in range(keys.shape[1]):
            k_net, _, k_pol = jax.random.split(keys[t, b], 3)
            keep[t, b] = np.asarray(jax.random.bernoulli(
                k_net, 1.0 - dropout, (vm, vm)))[src, dst]
            gumbel[t, b] = np.asarray(jax.random.gumbel(
                k_pol, (vm, num_devices)))[:n]
    return WindowNoise(torch.as_tensor(keep), torch.as_tensor(gumbel))


def _joint_setup(num_chains=B, population=None):
    """The reference's ``train_multi`` pieces for the three graphs, at
    (G=3, ``num_chains``), T=3, hidden 16; → dict."""
    graphs = _graphs()
    ref_fc = reffeat.shared_feature_config(graphs,
                                           reffeat.FeatureConfig(d_pos=8))
    ref_arrays = [reffeat.extract_features(g, ref_fc) for g in graphs]
    fc = FeatureConfig(**dataclasses.asdict(ref_fc))
    arrays = [extract_features(g, fc) for g in graphs]
    cfg = RefConfig(hidden_channel=HIDDEN, batch_chains=num_chains,
                    update_timestep=T, max_episodes=1, use_baseline=True)
    ref = RefHSDAG(cfg)
    rng, k_init = jax.random.split(jax.random.PRNGKey(0))
    params = ref.init(k_init, ref_arrays[0])
    gb = reffeat.batch_graph_arrays(ref_arrays)
    assert gb.padded
    pipe = RefPipeline.from_graphs(graphs, ref_paper(), backend="scan",
                                   v_max=gb.max_nodes)
    engine = ref._engine_multi(gb, pipe, population)
    return dict(graphs=graphs, arrays=arrays, cfg=cfg, params=params,
                gb=gb, pipe=pipe, engine=engine, rng=rng)


def _ref_agent(setup):
    ref = RefHSDAG(setup["cfg"])
    ref.params = setup["params"]
    ref._opt_state = ref._opt.init(ref.params)
    return ref


def _port_agent(setup, **kw):
    agent = HSDAG(HSDAGConfig.from_json(setup["cfg"].to_json()),
                  device="cpu")
    agent.load_params(jax.tree.map(np.asarray, setup["params"]))
    runner, stream, _ = agent.joint_runner(
        setup["graphs"], setup["arrays"], platform=paper_platform(), **kw)
    return agent, runner, stream


@pytest.fixture(scope="module")
def joint():
    s = _joint_setup()
    gb = s["gb"]
    stream = refloop.WindowStream.fresh(s["rng"], gb.x, B)
    out = s["engine"].rollout_window(s["params"], stream.z,
                                     stream.chain_rngs, num_steps=T,
                                     start_first=True)
    s["window"] = dict(zip(("z", "rngs", "keys", "fines", "ngroups",
                            "rewards", "latencies"), map(np.asarray, out)))
    keys = s["window"]["keys"]
    s["noise"] = [_padded_noise(keys[:, g], gb, g, 2) for g in range(3)]
    # Each chain's labels and coarse actions, replayed step by step with the
    # reference's own padded, masked step.
    step = jax.jit(functools.partial(RefHSDAG(s["cfg"])._step, train=True),
                   static_argnames=("first",))
    labels = np.zeros((3, T, B, gb.max_nodes), np.int64)
    actions = np.zeros_like(labels)
    for g in range(3):
        ops = [jnp.asarray(a[g]) for a in (gb.x, gb.adj, gb.edges,
                                           gb.node_mask, gb.edge_mask)]
        for b in range(B):
            z = ops[0]
            for t in range(T):
                o = step(s["params"], z, ops[0], ops[1], ops[2],
                         jnp.asarray(keys[t, g, b]), first=t == 0,
                         node_mask=ops[3], edge_mask=ops[4])
                labels[g, t, b] = np.asarray(o.parse.labels)
                actions[g, t, b] = np.asarray(o.policy.coarse_placement)
                z = o.z_next
    s["labels"], s["actions"] = labels, actions
    return s


def _ref_weights(rewards, cfg, reward_norm):
    """The reference runner's host weights (``loop.py``), no EMA."""
    r = rewards
    if reward_norm == "pergraph":
        r = (rewards - rewards.mean(axis=(0, 2), keepdims=True)) / (
            rewards.std(axis=(0, 2), keepdims=True) + 1e-8)
    w = step_weights(np.transpose(r, (1, 2, 0)), cfg.gamma)
    return np.transpose(w, (2, 0, 1))


@pytest.mark.parametrize("reward_norm", ["none", "pergraph"])
def test_a_joint_window_and_update_match_the_reference(joint, reward_norm):
    """One (G=3, B=2) window on the reference's draws: labels, actions and
    placements exact, groups, scan rewards and states at 1e-5, the G·B-mean
    Eq.-14 gradient, then the runner's whole episode — the EMA (``none``)
    or per-graph standardization, the update and the per-graph bests."""
    gb, win = joint["gb"], joint["window"]
    agent, runner, stream = _port_agent(joint, reward_norm=reward_norm)
    engine = runner.engine
    zs, records, fines, ngroups = engine.rollout_window(
        stream.z, num_steps=T, start_first=True, noise=joint["noise"])
    for g in range(3):
        n = int(gb.num_nodes[g])
        np.testing.assert_array_equal(records[g].labels.numpy(),
                                      joint["labels"][g][..., :n])
        np.testing.assert_array_equal(records[g].actions.numpy(),
                                      joint["actions"][g][..., :n])
        np.testing.assert_array_equal(fines[g].numpy(),
                                      win["fines"][:, g, :, :n])
        np.testing.assert_allclose(zs[g].numpy(), win["z"][g, :, :n],
                                   rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ngroups.numpy(), win["ngroups"])
    rewards, latencies = runner.pipeline.score_window(fines)
    np.testing.assert_allclose(rewards, win["rewards"], rtol=TOL)
    np.testing.assert_allclose(latencies, win["latencies"], rtol=TOL)

    cfg = joint["cfg"]
    w = window_weights(rewards, agent.cfg, reward_norm=reward_norm)
    ref_w = _ref_weights(np.asarray(win["rewards"], np.float64), cfg,
                         reward_norm)
    np.testing.assert_allclose(w, ref_w, rtol=1e-4, atol=1e-6)
    ref_grads = joint["engine"].window_grads(
        joint["params"], refloop.WindowStream.fresh(
            joint["rng"], gb.x, B).z, jnp.asarray(win["keys"]),
        jnp.asarray(ref_w), num_steps=T, start_first=True)
    grads = engine.window_grads(stream.z, records, torch.as_tensor(w),
                                start_first=True)
    names = [n for n, _ in agent.policy.named_parameters()]
    _assert_trees_close(tree_from_tensors(names, grads),
                        jax.tree.map(np.asarray, ref_grads), GRAD_RTOL,
                        "joint window gradient")

    # The runners' whole episode, each from its fresh stream.
    ref = _ref_agent(joint)
    ref_runner = refloop.EpisodeRunner(
        ref, joint["engine"], pipeline=joint["pipe"],
        tracker=refloop.BestTracker(gb.num_nodes, B),
        reward_norm=reward_norm,
        baseline=RefBaseline() if reward_norm == "none" else None)
    want = ref_runner.run_episode(refloop.WindowStream.fresh(joint["rng"],
                                                             gb.x, B))
    assert (runner.baseline is None) == (reward_norm == "pergraph")
    got = runner.run_episode(stream, noise=joint["noise"])
    if reward_norm == "none":
        assert runner.baseline.value == pytest.approx(
            ref_runner.baseline.value, rel=TOL)
    np.testing.assert_allclose(got["per_graph_best"], want["per_graph_best"],
                               rtol=TOL)
    assert got["mean_groups"] == want["mean_groups"]
    assert got["mean_reward"] == pytest.approx(want["mean_reward"], rel=TOL)
    for mine, ref_p in zip(runner.tracker.best_placements,
                           ref_runner.tracker.best_placements):
        np.testing.assert_array_equal(mine, ref_p)
    np.testing.assert_allclose(runner.tracker.chain_best,
                               ref_runner.tracker.chain_best, rtol=TOL)
    for a, b in zip(jax.tree.leaves(params_to_numpy(agent.policy)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_a_joint_population_round_matches_the_reference():
    """A population window over the (G=3, B=4) grid, its update at the
    window's temperatures, then a cull with a greedy restart in every graph
    row: temperatures, chain records (real columns) and states."""
    popcfg = refpop.PopulationConfig(cull_every=1, greedy_restart_every=1,
                                     exchange_fraction=0.5)
    nb = 4
    s = _joint_setup(nb, popcfg)
    gb, engine = s["gb"], s["engine"]
    ref = _ref_agent(s)
    ref_pop = engine.init_population(jax.random.PRNGKey(5), num_chains=nb)
    stream = refloop.WindowStream.fresh(s["rng"], gb.x, nb)
    temps = ref_pop.temperature
    (ref_z, _, ref_pop, keys, ref_fines, ref_ng, ref_rew, ref_lat) = \
        engine.rollout_window_pop(s["params"], stream.z,
                                  stream.chain_rngs, ref_pop,
                                  num_steps=T, start_first=True)
    keys = np.asarray(keys)
    noise = [_padded_noise(keys[:, g], gb, g, 2) for g in range(3)]
    agent, runner, pstream = _port_agent(
        s, reward_norm="pergraph",
        population=PopulationConfig.from_json(popcfg.to_json()))
    eng = runner.engine
    pop = eng.init_population(torch.Generator(), num_chains=nb,
                              temperatures=torch.tensor(
                                  np.asarray(temps)))
    zs, records, fines, ngroups = eng.rollout_window(
        pstream.z, num_steps=T, start_first=True, noise=noise,
        temperature=pop.temperature)
    rewards, latencies = runner.pipeline.score_window(fines)
    pop = eng.update_population(pop, eng.pad(fines), latencies)
    np.testing.assert_array_equal(ngroups.numpy(), np.asarray(ref_ng))
    np.testing.assert_allclose(rewards, np.asarray(ref_rew), rtol=TOL)
    np.testing.assert_allclose(pop.best_latency.numpy(),
                               np.asarray(ref_pop.best_latency),
                               rtol=TOL)
    w = window_weights(rewards, agent.cfg, reward_norm="pergraph")
    ref_grads = engine.window_grads_pop(
        s["params"], stream.z, jnp.asarray(keys), jnp.asarray(w),
        temps, num_steps=T, start_first=True)
    grads = eng.window_grads(pstream.z, records, torch.as_tensor(w),
                             start_first=True)
    names = [n for n, _ in agent.policy.named_parameters()]
    _assert_trees_close(tree_from_tensors(names, grads),
                        jax.tree.map(np.asarray, ref_grads), F32_RTOL,
                        "joint population gradient")
    ref.apply_grads(ref_grads)
    agent.apply_grads(grads)

    k_use = jax.random.split(ref_pop.rng, 3)[0]
    from test_torch_population import _ref_draws
    draws = _ref_draws(popcfg, k_use, range(3), nb)
    ref_pop, ref_z = engine.pbt_step(ref.params, ref_pop, ref_z,
                                     use_greedy=True)
    pop, zs = eng.pbt_step(pop, zs, use_greedy=True, draws=draws)
    np.testing.assert_allclose(pop.temperature.numpy(),
                               np.asarray(ref_pop.temperature),
                               rtol=1e-6)
    np.testing.assert_allclose(pop.best_latency.numpy(),
                               np.asarray(ref_pop.best_latency),
                               rtol=TOL)
    for g in range(3):
        n = int(gb.num_nodes[g])
        np.testing.assert_array_equal(
            pop.best_fine[g, :, :n].numpy(),
            np.asarray(ref_pop.best_fine)[g, :, :n])
        np.testing.assert_allclose(zs[g].numpy(),
                                   np.asarray(ref_z)[g, :, :n],
                                   rtol=TOL, atol=TOL)


# ------------------------------------------------------------- the trainer
def _cfg(**kw):
    base = dict(num_devices=2, hidden_channel=HIDDEN, max_episodes=3,
                update_timestep=4, batch_chains=3)
    base.update(kw)
    return HSDAGConfig(**base)


def test_one_graph_train_multi_is_search_bit_for_bit():
    """G=1 with ``reward_norm="none"`` (and the EMA baseline) is the
    port's search draw for draw: history, best placement and the final
    weights, bitwise."""
    g = random_dag(np.random.default_rng(0), 14, p=0.25)
    arrays = extract_features(g, FeatureConfig(d_pos=8))
    cfg = _cfg(use_baseline=True)
    rs = HSDAG(cfg, device="cpu").search(g, arrays, platform=paper_platform())
    rm = MultiGraphTrainer(cfg, reward_norm="none", device="cpu").train(
        [g], [arrays], platform=paper_platform())
    for key in ("best_latency", "mean_reward", "mean_groups"):
        assert [h[key] for h in rs.history] == [h[key] for h in rm.history]
    assert [h["per_graph_best"] for h in rm.history] == \
        [[h["best_latency"]] for h in rs.history]
    np.testing.assert_array_equal(rs.best_placement, rm.best_placements[0])
    assert rs.best_latency == float(rm.best_latencies[0])
    np.testing.assert_array_equal(rs.chain_best, rm.chain_best[0])
    for a, b in zip(rs.params.parameters(), rm.params.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("engine", ["auto", "level", "reference"])
def test_train_multi_joint_three_graphs(engine):
    """One shared policy over three graphs of different sizes: every
    per-graph best and greedy decode replays on the host scheduler, shapes
    and counts as the reference's."""
    graphs = [make_diamond()] + _graphs()[1:]
    plat = paper_platform()
    tr = MultiGraphTrainer(_cfg(batch_chains=4, engine=engine), device="cpu")
    res = tr.train(graphs, platform=plat)
    assert res.chain_best.shape == (3, 4)
    assert res.num_evaluations == 3 * 4 * 3 * 4
    assert len(res.history) == 3 and all(
        len(h["per_graph_best"]) == 3 for h in res.history)
    order = {"level": lambda g: cm.sim_arrays(g, plat,
                                              schedule="level").order}
    for g, p, lat in zip(graphs, res.best_placements, res.best_latencies):
        assert p.shape == (g.num_nodes,)
        o = order[engine](g) if engine in order else None
        np.testing.assert_allclose(simulate(g, p, plat, order=o).latency,
                                   lat, rtol=TOL)
    for g, p, lat in zip(graphs, res.greedy_placements,
                         res.greedy_latencies):
        assert simulate(g, p, plat).latency == lat
    assert tr.feature_config is not None and tr.feature_config.op_vocab


def test_train_multi_population_keeps_each_rows_best():
    graphs = _graphs()
    tr = MultiGraphTrainer(_cfg(batch_chains=4, max_episodes=4),
                           device="cpu")
    res = tr.train(graphs, platform=paper_platform(),
                   population={"cull_every": 1, "greedy_restart_every": 2})
    best = [h["pop_best_latency"] for h in res.history]
    assert all(h.get("culled") for h in res.history)
    assert all(b2 <= b1 for b1, b2 in zip(best, best[1:]))
    assert best[-1] == pytest.approx(min(res.best_latencies), rel=1e-6)


def test_train_multi_device_head_masks_with_the_scan_reward():
    """``head="device"`` over a fleet whose second device cannot hold the
    large nodes: with the scan reward every sampled placement fits
    (``fit_ok``), graph by graph."""
    from repro_torch.core.sim import RewardPipeline
    from repro_torch.platforms import nvlink_island
    graphs = _graphs()
    # the second device holds 2,000 bytes: nodes larger than that fit
    # only the first
    fleet = nvlink_island(2, 1, mem_capacity=1e6, island_scale=0.002)
    sampled = []
    real = RewardPipeline.score_window

    def spy(self, fines):
        sampled.append([torch.as_tensor(f).clone() for f in fines])
        return real(self, fines)

    tr = MultiGraphTrainer(_cfg(head="device", num_devices=2,
                                max_episodes=2), device="cpu")
    RewardPipeline.score_window = spy
    try:
        res = tr.train(graphs, platform=fleet)
    finally:
        RewardPipeline.score_window = real
    assert len(sampled) == 2
    masked = 0
    for g, graph in enumerate(graphs):
        fit_ok = torch.as_tensor(cm.sim_arrays(graph, fleet).fit_ok)
        n = graph.num_nodes
        for window in sampled:
            p = window[g]
            assert fit_ok[torch.arange(n), p].all()
        masked += int((~fit_ok).sum())
    assert masked > 0
    assert np.isfinite(res.best_latencies).all()


def test_zero_shot_transfer_to_an_unseen_dag():
    rng = np.random.default_rng(9)
    graphs = [random_dag(rng, 10, p=0.25), random_dag(rng, 15, p=0.2)]
    plat = paper_platform()
    tr = MultiGraphTrainer(_cfg(batch_chains=2, max_episodes=2),
                           device="cpu")
    tr.train(graphs, platform=plat)
    unseen = random_dag(rng, 21, p=0.2)
    p, lat = tr.evaluate_zero_shot(unseen, platform=plat)
    assert p.shape == (21,) and set(np.unique(p)) <= {0, 1}
    assert simulate(unseen, p, plat).latency == lat
    arrays = extract_features(unseen, tr.feature_config)
    np.testing.assert_array_equal(
        tr.evaluate_zero_shot(unseen, platform=plat, arrays=arrays)[0], p)
    with pytest.raises(ValueError, match="feature_config"):
        fresh = MultiGraphTrainer(_cfg(), device="cpu")
        fresh.init(arrays)
        fresh.evaluate_zero_shot(unseen, platform=plat)


def test_train_multi_validations(diamond):
    arrays = extract_features(diamond, FeatureConfig(d_pos=8))
    with pytest.raises(ValueError):
        MultiGraphTrainer(_cfg(), reward_norm="bogus", device="cpu")
    with pytest.raises(ValueError):
        MultiGraphTrainer(_cfg(), device="cpu").train(
            [], platform=paper_platform())
    with pytest.raises(ValueError):
        MultiGraphTrainer(_cfg(num_devices=5), device="cpu").train(
            [diamond], [arrays], platform=paper_platform())
    with pytest.raises(ValueError, match="scalar"):
        MultiGraphTrainer(_cfg(engine="scalar"), device="cpu").train(
            [diamond], [arrays], platform=paper_platform())
    with pytest.raises(ValueError, match="reward_norm"):
        HSDAG(_cfg(), device="cpu").train_multi(
            [diamond], [arrays], platform=paper_platform(),
            reward_norm="bogus")
    other = random_dag(np.random.default_rng(0), 9, p=0.3)
    mixed = [arrays, extract_features(other, FeatureConfig(d_pos=8))]
    with pytest.raises(ValueError, match="feature widths"):
        batch_graph_arrays(mixed)
    with pytest.raises(ValueError, match="feature widths"):
        MultiGraphTrainer(_cfg(), device="cpu").train(
            [diamond, other], mixed, platform=paper_platform())
