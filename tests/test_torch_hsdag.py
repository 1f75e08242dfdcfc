"""Port parity, the slice as a whole: rollout windows, rewards from the level
and scan backends, the search's engine dispatch, the Eq.-14 replay gradient, the Adam update, and the greedy decode
from a reference checkpoint — at a small size, with the same initial weights
and the reference's own random draws fed to the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_policy as ref_restore_policy  # noqa: E402
from repro.checkpoint import save_policy as ref_save_policy  # noqa: E402
from repro.core import HSDAG as RefHSDAG  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.core import paper_platform as ref_paper  # noqa: E402
from repro.core.reinforce import step_weights  # noqa: E402
from repro.core.sim import RewardPipeline as RefPipeline  # noqa: E402

from repro_torch.checkpoint import (load_reference_policy,  # noqa: E402
                                    params_to_numpy, tree_from_tensors)
from repro_torch.core import (HSDAG, HSDAGConfig, extract_features,  # noqa: E402
                              get_backend, paper_platform, simulate)
from repro_torch.core.sim import (ChainStreams, RewardPipeline,  # noqa: E402
                                  WindowNoise)
from repro_torch.kernels import gcn_graph  # noqa: E402

from conftest import random_dag  # noqa: E402

B, T, HIDDEN = 2, 3, 16
TOL = 1e-5
# Window gradients sum f32 products over T steps, B chains and every node in
# a different order in each framework (XLA vs ATen reductions, dense vs
# edge-list aggregation), so they agree to a looser bound than forward
# values: 1e-4 of each leaf's largest entry.
GRAD_RTOL = 5e-5


def _ref_cfg(**kw):
    return RefConfig(hidden_channel=HIDDEN, batch_chains=B, update_timestep=T,
                     engine="level", max_episodes=1, **kw)


@pytest.fixture(scope="module")
def setup():
    g = random_dag(np.random.default_rng(0), 24)
    arrays = extract_features(g)
    ref = RefHSDAG(_ref_cfg())
    params = ref.init(jax.random.PRNGKey(0), arrays)
    tree = jax.tree.map(np.asarray, params)
    agent = HSDAG(HSDAGConfig.from_json(ref.cfg.to_json()), device="cpu")
    agent.load_params(tree)
    return dict(g=g, arrays=arrays, ref=ref, agent=agent)


def _noise(keys, arrays, num_devices, parse_dropout=0.0):
    """The reference's edge masks, parse-dropout masks (when
    ``parse_dropout`` > 0) and Gumbel noise, rebuilt from its per-step keys
    (``_step`` splits each as k_net, k_parse, k_pol)."""
    src, dst = arrays.edges[:, 0], arrays.edges[:, 1]
    keep = np.zeros(keys.shape[:2] + (len(src),), np.float32)
    parse = np.zeros_like(keep)
    gumbel = np.zeros(keys.shape[:2] + (arrays.num_nodes, num_devices),
                      np.float32)
    for t in range(keys.shape[0]):
        for b in range(keys.shape[1]):
            k_net, k_parse, k_pol = jax.random.split(keys[t, b], 3)
            keep[t, b] = np.asarray(jax.random.bernoulli(
                k_net, 0.8, arrays.adj.shape))[src, dst]
            parse[t, b] = np.asarray(jax.random.bernoulli(
                k_parse, 1.0 - parse_dropout, (len(src),)))
            gumbel[t, b] = np.asarray(jax.random.gumbel(
                k_pol, (arrays.num_nodes, num_devices)))
    return WindowNoise(torch.as_tensor(keep), torch.as_tensor(gumbel),
                       torch.as_tensor(parse) if parse_dropout > 0 else None)


def _assert_trees_close(mine, want, rtol, what):
    for path, a in jax.tree_util.tree_leaves_with_path(mine):
        b = np.asarray(_at(want, path))
        scale = max(float(np.abs(b).max()), 1e-12)
        err = float(np.abs(a - b).max())
        assert err <= rtol * scale, (what, jax.tree_util.keystr(path), err,
                                     scale)


def _at(tree, path):
    for p in path:
        tree = tree[getattr(p, "key", getattr(p, "idx", None))]
    return tree


def _windows_match_the_reference(g, arrays, ref, agent, backend, windows):
    """``windows`` rollout windows of both engines from the same weights,
    the reference's draws fed to the port, each scored by ``backend`` on
    both sides: placements, groups, rewards and states, then the Eq.-14
    gradients and the Adam update, window by window."""
    ref_pipe = RefPipeline.from_platform(g, ref_paper(), backend)
    ref_engine = ref._engine_single(arrays, ref_pipe)
    pipe = RewardPipeline.from_platform(g, paper_platform(), backend,
                                        device="cpu")
    engine = agent.rollout_engine(arrays)

    rng = jax.random.PRNGKey(1)
    rngs = jnp.stack([rng] + [jax.random.fold_in(rng, b)
                              for b in range(1, B)])[None]
    x0 = jnp.asarray(arrays.x)
    ref_z = jnp.broadcast_to(x0, (1, B) + x0.shape)
    z = engine.x0.expand(B, *engine.x0.shape)
    for window in range(windows):
        first = window == 0
        (ref_z1, rngs, keys, ref_fines, ref_ng, ref_rew, ref_lat) = \
            ref_engine.rollout_window(ref.params, ref_z, rngs, num_steps=T,
                                      start_first=first)
        if ref_pipe.fused:       # scored inside the reference's rollout
            ref_rew = np.asarray(ref_rew, np.float64)[:, 0]
            ref_lat = np.asarray(ref_lat, np.float64)[:, 0]
        else:
            ref_rew, ref_lat = ref_pipe.score_window(
                np.asarray(ref_fines)[:, 0])

        noise = _noise(np.asarray(keys)[:, 0], arrays, 2)
        z1, record, fines, ngroups = engine.rollout_window(
            z, num_steps=T, start_first=first, noise=noise)
        rewards, latencies = pipe.score_window(fines)
        np.testing.assert_array_equal(fines.numpy(),
                                      np.asarray(ref_fines)[:, 0])
        np.testing.assert_array_equal(ngroups.numpy(),
                                      np.asarray(ref_ng)[:, 0])
        np.testing.assert_allclose(rewards, ref_rew, rtol=TOL)
        np.testing.assert_allclose(latencies, ref_lat, rtol=TOL)
        np.testing.assert_allclose(z1.numpy(), np.asarray(ref_z1)[0],
                                   rtol=TOL, atol=TOL)

        ref_w = step_weights(ref_rew.T, ref.cfg.gamma).T
        ref_grads = ref_engine.window_grads(
            ref.params, ref_z, keys, jnp.asarray(ref_w)[:, None],
            num_steps=T, start_first=first)
        w = step_weights(rewards.T, agent.cfg.gamma).T
        grads = engine.window_grads(z, record, torch.as_tensor(w.copy()),
                                    start_first=first)
        names = [n for n, _ in agent.policy.named_parameters()]
        _assert_trees_close(tree_from_tensors(names, grads),
                            jax.tree.map(np.asarray, ref_grads), GRAD_RTOL,
                            f"window {window} gradient")

        ref.apply_grads(ref_grads)
        agent.apply_grads(grads)
        mine = params_to_numpy(agent.policy)
        want = jax.tree.map(np.asarray, ref.params)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
        ref_z, z = ref_z1, z1


def test_two_windows_and_updates_match_the_reference(setup):
    _windows_match_the_reference(
        *(setup[k] for k in ("g", "arrays", "ref", "agent")), "level", 2)


def test_a_window_scored_by_the_scan_backend_matches_the_reference(setup):
    """The default reward: the reference's in-rollout ``simulate_jax`` and
    the port's scan backend on the same window, from fresh weights."""
    g, arrays = setup["g"], setup["arrays"]
    ref = RefHSDAG(_ref_cfg())
    params = ref.init(jax.random.PRNGKey(0), arrays)
    agent = HSDAG(HSDAGConfig.from_json(ref.cfg.to_json()), device="cpu")
    agent.load_params(jax.tree.map(np.asarray, params))
    _windows_match_the_reference(g, arrays, ref, agent, "scan", 1)


def test_place_from_a_reference_checkpoint(setup, tmp_path):
    arrays = setup["arrays"]
    ref = RefHSDAG(_ref_cfg(seed=3))
    params = ref.init(jax.random.PRNGKey(7), arrays)
    ref_save_policy(str(tmp_path), params, step=5,
                    meta={"config": ref.cfg.to_json()})
    tree, manifest = load_reference_policy(str(tmp_path))
    assert manifest["step"] == 5
    agent = HSDAG(HSDAGConfig.from_json(manifest["config"]), device="cpu")
    agent.load_params(tree)
    restored = RefHSDAG(_ref_cfg())
    restored.init(jax.random.PRNGKey(0), arrays)
    restored.params, _, step, _ = ref_restore_policy(str(tmp_path),
                                                     restored.params)
    assert step == 5
    placement = agent.place(arrays)
    np.testing.assert_array_equal(placement, restored.place(arrays))
    assert len(set(placement.tolist())) == 2
    # The decode's logits agree too, not only their argmax.
    x0 = jnp.asarray(arrays.x)
    out = restored._step(restored.params, x0, x0, jnp.asarray(arrays.adj),
                         jnp.asarray(arrays.edges), jax.random.PRNGKey(0),
                         first=True, train=False, greedy=True)
    graph = gcn_graph(arrays.edges, arrays.num_nodes, "cpu")
    xt = torch.as_tensor(arrays.x)[None]
    with torch.no_grad():
        mine = agent.policy.step(xt, xt, graph,
                                 torch.ones(1, graph.num_edges), first=True,
                                 greedy=True)
    np.testing.assert_allclose(mine.policy.logits[0].numpy(),
                               np.asarray(out.policy.logits), rtol=TOL,
                               atol=TOL)


def test_search_runs_the_level_engine_end_to_end(setup):
    g, arrays = setup["g"], setup["arrays"]
    agent = HSDAG(HSDAGConfig(hidden_channel=HIDDEN, batch_chains=3,
                              update_timestep=4, max_episodes=2,
                              engine="level"), device="cpu")
    res = agent.search(g, arrays, platform=paper_platform())
    assert len(res.history) == 2 and res.num_evaluations == 2 * 4 * 3
    assert res.chain_best.shape == (3,)
    backend = get_backend("level", device="cpu")
    order = backend.schedule_order(backend.prepare(g, paper_platform()))
    host = simulate(g, res.best_placement, paper_platform(), order=order)
    np.testing.assert_allclose(res.best_latency, host.latency, rtol=TOL)
    assert res.best_latency == pytest.approx(res.chain_best.min())
    p = agent.place(arrays)
    assert p.shape == (g.num_nodes,) and set(np.unique(p)) <= {0, 1}


@pytest.mark.parametrize("engine,backend", [
    ("auto", "scan"), ("batched", "scan"), ("scan", "scan"),
    ("reference", "reference")])
def test_search_runs_each_engine(setup, engine, backend):
    """Every engine the reference takes with a platform runs the batched
    loop; its best latency is the host scheduler's in the order of the
    backend that scored it (``"auto"`` and ``"batched"``: the scan
    backend, heap-Kahn order)."""
    g, arrays = setup["g"], setup["arrays"]
    agent = HSDAG(HSDAGConfig(hidden_channel=HIDDEN, batch_chains=2,
                              update_timestep=3, max_episodes=2,
                              engine=engine), device="cpu")
    res = agent.search(g, arrays, platform=paper_platform())
    assert len(res.history) == 2 and res.num_evaluations == 2 * 3 * 2
    b = get_backend(backend, device="cpu")
    order = b.schedule_order(b.prepare(g, paper_platform()))
    host = simulate(g, res.best_placement, paper_platform(), order=order)
    np.testing.assert_allclose(res.best_latency, host.latency, rtol=TOL)
    if engine != "reference":
        default = simulate(g, res.best_placement, paper_platform())
        np.testing.assert_allclose(res.best_latency, default.latency,
                                   rtol=TOL)


def test_search_engine_reference_matches_host_reward_fn(setup):
    """engine="reference" is the host scheduler behind the pipeline: its
    search is the one a reward_fn wrapping simulate() drives."""
    g, arrays = setup["g"], setup["arrays"]
    plat = paper_platform()
    seen = []

    def reward_fn(p):
        seen.append(p.shape)
        r = simulate(g, p, plat)
        return r.reward, r.latency

    def cfg(engine):
        return HSDAGConfig(hidden_channel=HIDDEN, batch_chains=2,
                           update_timestep=3, max_episodes=2, engine=engine)
    ra = HSDAG(cfg("batched"), device="cpu").search(g, arrays,
                                                    reward_fn=reward_fn)
    rb = HSDAG(cfg("reference"), device="cpu").search(g, arrays,
                                                      platform=plat)
    assert seen == [(g.num_nodes,)] * (2 * 3 * 2)
    assert [h["best_latency"] for h in ra.history] == \
        [h["best_latency"] for h in rb.history]
    assert [h["mean_reward"] for h in ra.history] == \
        [h["mean_reward"] for h in rb.history]
    np.testing.assert_array_equal(ra.best_placement, rb.best_placement)


def test_search_rejects_ambiguous_or_missing_reward_sources(setup):
    g, arrays = setup["g"], setup["arrays"]
    agent = HSDAG(HSDAGConfig(hidden_channel=HIDDEN, batch_chains=2),
                  device="cpu")
    with pytest.raises(ValueError, match="needs a reward source"):
        agent.search(g, arrays)
    with pytest.raises(ValueError, match="ambiguous"):
        agent.search(g, arrays, platform=paper_platform(),
                     reward_fn=lambda p: (1.0, 1.0))
    with pytest.raises(ValueError, match="names a simulator backend"):
        agent.search(g, arrays, reward_fn=lambda p: (1.0, 1.0),
                     engine="level")
    with pytest.raises(ValueError, match="exceeds the platform"):
        HSDAG(HSDAGConfig(hidden_channel=HIDDEN, num_devices=3),
              device="cpu").search(g, arrays, platform=paper_platform())
    with pytest.raises(ValueError, match="unknown engine"):
        agent.search(g, arrays, platform=paper_platform(), engine="nope")


@pytest.mark.parametrize("engine", ["auto", "scalar"])
def test_unported_engines_name_their_roadmap_item(setup, engine):
    """The reference's scalar loop — ``engine="scalar"`` (here given a
    platform: the host ``simulate`` scores it), and ``"auto"`` with one chain
    and a host reward_fn — once raised, naming the ROADMAP item that would
    port it; both now run it, one placement scored at a time."""
    g, arrays = setup["g"], setup["arrays"]
    plat = paper_platform()
    calls = []

    def reward_fn(p):
        calls.append(p.shape)
        r = simulate(g, p, plat)
        return r.reward, r.latency

    agent = HSDAG(HSDAGConfig(hidden_channel=HIDDEN, engine=engine,
                              batch_chains=1, update_timestep=3,
                              max_episodes=2), device="cpu")
    source = ({"reward_fn": reward_fn} if engine == "auto"
              else {"platform": plat})
    res = agent.search(g, arrays, **source)
    assert len(res.history) == 2 and res.num_evaluations == 2 * 3
    assert res.chain_best.tolist() == [res.best_latency]
    assert calls == ([(g.num_nodes,)] * 6 if engine == "auto" else [])
    host = simulate(g, res.best_placement, plat).latency
    assert res.best_latency == pytest.approx(host, rel=TOL)
    assert res.best_latency == min(h["best_latency"] for h in res.history)


def test_config_json_round_trips_with_the_reference():
    ref = _ref_cfg(seed=4, entropy_coef=0.01)
    assert HSDAGConfig.from_json(ref.to_json()).to_json() == ref.to_json()
    assert RefConfig.from_json(HSDAGConfig().to_json()) == RefConfig()
    with pytest.raises(ValueError, match="unknown HSDAGConfig fields"):
        HSDAGConfig.from_json('{"hiden_channel": 3}')


def test_chain_zero_keeps_its_stream_whatever_the_chain_count():
    one = ChainStreams(7, 1, "cpu").draw(5, 4, 2, 0.2)
    three = ChainStreams(7, 3, "cpu").draw(5, 4, 2, 0.2)
    for a, b in zip(one, three):
        assert torch.equal(a[0], b[0])
    assert not torch.equal(three[1][0], three[1][1])
