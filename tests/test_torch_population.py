"""Port parity, population search: ``PopulationConfig``'s JSON, the chain
counts, ``update_chain_bests``, ``pbt_rows`` on rows with ties, the cadence
controller, and two windows of a population search (a cull, then a greedy
restart) against the reference's engine, with the reference's own draws fed
to the port; then the port's ``search(population=...)`` end to end."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HSDAG as RefHSDAG  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.core import paper_platform as ref_paper  # noqa: E402
from repro.core.reinforce import step_weights  # noqa: E402
from repro.core.sim import RewardPipeline as RefPipeline  # noqa: E402
from repro.core.train import population as refpop  # noqa: E402

from repro_torch.checkpoint import params_to_numpy, tree_from_tensors  # noqa: E402,E501
from repro_torch.core import (HSDAG, HSDAGConfig, extract_features,  # noqa: E402
                              paper_platform)
from repro_torch.core.sim import MultiRolloutEngine, RewardPipeline  # noqa: E402,E501
from repro_torch.core.train import (PBTDraws, PopulationConfig,  # noqa: E402
                                    PopulationController, chain_counts,
                                    init_chain_state, pbt_rows,
                                    update_chain_bests)

from conftest import random_dag  # noqa: E402
from test_torch_grad_precision import F32_RTOL  # noqa: E402
from test_torch_hsdag import TOL, _assert_trees_close, _noise  # noqa: E402

B, T, HIDDEN = 4, 3, 16


def _ref_draws(cfg, key, rows, num_chains):
    """The draws ``pbt_rows`` of the reference takes from ``key`` for each
    row id, as a ``PBTDraws``."""
    n_elite, _ = refpop.chain_counts(cfg, num_chains)
    log_p = float(np.log(cfg.perturb))
    donor, pert, exch = [], [], []
    for r in rows:
        k_donor, k_pert, k_exch = jax.random.split(
            jax.random.fold_in(key, r), 3)
        donor.append(jax.random.randint(k_donor, (num_chains,), 0, n_elite))
        pert.append(jax.random.uniform(k_pert, (num_chains,), minval=-log_p,
                                       maxval=log_p))
        exch.append(jax.random.uniform(k_exch, (num_chains,)))
    return PBTDraws(torch.as_tensor(np.asarray(donor), dtype=torch.long),
                    torch.as_tensor(np.asarray(pert)),
                    torch.as_tensor(np.asarray(exch)))


def test_population_config_json_round_trips_with_the_reference():
    ref = refpop.PopulationConfig(cull_every=2, cull_fraction=0.5,
                                  greedy_restart_every=3, seed=7)
    mine = PopulationConfig.from_json(ref.to_json())
    assert mine.to_json() == ref.to_json()
    assert refpop.PopulationConfig.from_json(
        PopulationConfig().to_json()) == refpop.PopulationConfig()
    assert PopulationConfig.from_json(json.loads(ref.to_json())) == mine
    with pytest.raises(ValueError, match="unknown PopulationConfig fields"):
        PopulationConfig.from_json('{"cull_evry": 2}')
    for bad in ({"cull_every": 0}, {"perturb": 0.5},
                {"init_lo": 0.1}, {"greedy_restart_every": -1}):
        with pytest.raises(ValueError):
            PopulationConfig(**bad)
        with pytest.raises(ValueError):
            refpop.PopulationConfig(**bad)


@pytest.mark.parametrize("num_chains", [2, 4, 7, 16, 320])
def test_chain_counts_match_the_reference(num_chains):
    cfg = PopulationConfig()
    assert chain_counts(cfg, num_chains) == refpop.chain_counts(
        refpop.PopulationConfig(), num_chains)
    with pytest.raises(ValueError, match="too small"):
        chain_counts(cfg, 1)


def test_update_chain_bests_matches_the_reference():
    """Ties over T (the first minimum wins) and ties with the record (the
    record stays)."""
    rng = np.random.default_rng(3)
    lat = rng.integers(1, 4, (5, 6)).astype(np.float32)   # many ties
    fines = rng.integers(0, 2, (5, 6, 9)).astype(np.int32)
    best = np.array([np.inf, 1.0, 2.0, 3.0, 1.0, np.inf], np.float32)
    best_fine = rng.integers(0, 2, (6, 9)).astype(np.int32)
    ref = refpop.update_chain_bests(
        refpop.ChainState(jnp.ones((1, 6)), jnp.asarray(best)[None],
                          jnp.asarray(best_fine)[None],
                          jax.random.PRNGKey(0)),
        jnp.asarray(fines)[:, None], jnp.asarray(lat)[:, None])
    state = init_chain_state(PopulationConfig(), torch.Generator(),
                             num_graphs=1, num_chains=6, num_nodes=9,
                             temperatures=torch.ones(6))
    state = state._replace(best_latency=torch.as_tensor(best)[None],
                           best_fine=torch.as_tensor(best_fine).long()[None])
    mine = update_chain_bests(
        state, torch.as_tensor(fines).long()[:, None],
        torch.as_tensor(lat, dtype=torch.float64)[:, None])
    np.testing.assert_array_equal(mine.best_latency.numpy(),
                                  np.asarray(ref.best_latency))
    np.testing.assert_array_equal(mine.best_fine.numpy(),
                                  np.asarray(ref.best_fine))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pbt_rows_with_ties_match_the_reference(seed):
    """Rows full of tied latencies — every chain that inherits the elite's
    record ties with it — rank in chain order on both sides."""
    cfg = refpop.PopulationConfig(exchange_fraction=0.5)
    lat = np.array([[3.0, 1.0, 1.0, 2.0, 1.0, 5.0, 5.0, 0.5],
                    [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                    [1.0, 4.0, 1.0, 4.0, 0.5, 0.5, 9.0, 9.0]], np.float32)
    temp = np.random.default_rng(seed).uniform(0.7, 1.5, lat.shape) \
        .astype(np.float32)
    key = jax.random.PRNGKey(seed)
    rows = np.arange(3)
    ref = refpop.pbt_rows(cfg, key, jnp.asarray(lat), jnp.asarray(temp),
                          jnp.asarray(rows))
    mine = pbt_rows(PopulationConfig.from_json(cfg.to_json()),
                    _ref_draws(cfg, key, rows, lat.shape[1]),
                    torch.as_tensor(lat), torch.as_tensor(temp))
    for name, a, b in zip(("culled", "inherit", "new_temp", "jstar"), mine,
                          ref):
        if name == "new_temp":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


def test_controller_cadence_and_state_match_the_reference():
    cfg = refpop.PopulationConfig(cull_every=2, greedy_restart_every=2)
    ref = refpop.PopulationController(cfg, num_chains=8)
    mine = PopulationController(PopulationConfig.from_json(cfg.to_json()),
                                num_chains=8)
    for _ in range(9):
        assert mine.note_window() == ref.note_window()
    assert mine.summary() == ref.summary()
    state = json.loads(json.dumps(mine.state_dict()))
    want = ref.state_dict()
    assert state == {k: want[k] for k in state}
    again = PopulationController(mine.cfg, num_chains=8)
    again.load_state_dict(state)
    assert again.summary() == mine.summary()


@pytest.fixture(scope="module")
def graph():
    g = random_dag(np.random.default_rng(0), 24)
    return g, extract_features(g)


def test_two_population_windows_match_the_reference(graph):
    """Window 1 ends in a cull, window 2 in a greedy restart: placements,
    groups, rewards, states and chain records after each window, the
    gradient at the window's temperatures, the update, and the PBT round."""
    g, arrays = graph
    popcfg = refpop.PopulationConfig(cull_every=1, greedy_restart_every=2,
                                     exchange_fraction=0.5)
    ref = RefHSDAG(RefConfig(hidden_channel=HIDDEN, batch_chains=B,
                             update_timestep=T, engine="level",
                             max_episodes=1))
    params = ref.init(jax.random.PRNGKey(0), arrays)
    agent = HSDAG(HSDAGConfig.from_json(ref.cfg.to_json()), device="cpu")
    agent.load_params(jax.tree.map(np.asarray, params))
    ref_pipe = RefPipeline.from_platform(g, ref_paper(), "level")
    ref_engine = ref._engine_single(arrays, ref_pipe, popcfg)
    ref_pop = ref_engine.init_population(jax.random.PRNGKey(5),
                                         num_chains=B)
    ref_ctl = refpop.PopulationController(popcfg, num_chains=B)
    cfg = PopulationConfig.from_json(popcfg.to_json())
    pipe = RewardPipeline.from_platform(g, paper_platform(), "level",
                                        device="cpu")
    # the search's engine: one graph, its population a (1, B) row
    multi = MultiRolloutEngine([agent.rollout_engine(arrays)],
                               population=cfg)
    engine = multi.engines[0]
    pop = multi.init_population(
        torch.Generator(), num_chains=B,
        temperatures=torch.tensor(np.asarray(ref_pop.temperature)))
    ctl = PopulationController(cfg, num_chains=B)

    rng = jax.random.PRNGKey(1)
    rngs = jnp.stack([rng] + [jax.random.fold_in(rng, b)
                              for b in range(1, B)])[None]
    x0 = jnp.asarray(arrays.x)
    ref_z = jnp.broadcast_to(x0, (1, B) + x0.shape)
    z = engine.x0.expand(B, *engine.x0.shape)
    names = [n for n, _ in agent.policy.named_parameters()]
    restarts = []
    for window in range(2):
        first = window == 0
        temps = ref_pop.temperature
        (ref_z1, rngs, ref_pop, keys, ref_fines, ref_ng, _, _) = \
            ref_engine.rollout_window_pop(ref.params, ref_z, rngs, ref_pop,
                                          num_steps=T, start_first=first)
        ref_rew, ref_lat = ref_pipe.score_window(np.asarray(ref_fines)[:, 0])
        ref_pop = ref_engine.update_population(
            ref_pop, ref_fines, jnp.asarray(ref_lat, jnp.float32)[:, None])

        z1, record, fines, ngroups = engine.rollout_window(
            z, num_steps=T, start_first=first,
            noise=_noise(np.asarray(keys)[:, 0], arrays, 2),
            temperature=pop.temperature[0])
        rewards, latencies = pipe.score_window(fines)
        pop = multi.update_population(pop, fines[:, None],
                                      latencies[:, None])
        np.testing.assert_array_equal(fines.numpy(),
                                      np.asarray(ref_fines)[:, 0])
        np.testing.assert_array_equal(ngroups.numpy(),
                                      np.asarray(ref_ng)[:, 0])
        np.testing.assert_allclose(rewards, ref_rew, rtol=TOL)
        np.testing.assert_allclose(z1.numpy(), np.asarray(ref_z1)[0],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(pop.best_latency.numpy(),
                                   np.asarray(ref_pop.best_latency),
                                   rtol=TOL)
        np.testing.assert_array_equal(pop.best_fine.numpy(),
                                      np.asarray(ref_pop.best_fine))

        w = step_weights(ref_rew.T, ref.cfg.gamma).T
        ref_grads = ref_engine.window_grads_pop(
            ref.params, ref_z, keys, jnp.asarray(w)[:, None], temps,
            num_steps=T, start_first=first)
        grads = engine.window_grads(
            z, record, torch.as_tensor(step_weights(rewards.T,
                                                    0.99).T.copy()),
            start_first=first)
        _assert_trees_close(tree_from_tensors(names, grads),
                            jax.tree.map(np.asarray, ref_grads), F32_RTOL,
                            f"window {window} gradient")
        ref.apply_grads(ref_grads)
        agent.apply_grads(grads)
        for a, b in zip(jax.tree.leaves(params_to_numpy(agent.policy)),
                        jax.tree.leaves(jax.tree.map(np.asarray,
                                                     ref.params))):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)

        due, use_greedy = ctl.note_window()
        assert (due, use_greedy) == ref_ctl.note_window() and due
        restarts.append(use_greedy)
        k_use = jax.random.split(ref_pop.rng, 3)[0]
        draws = _ref_draws(popcfg, k_use, [0], B)
        ref_pop, ref_z1 = ref_engine.pbt_step(ref.params, ref_pop, ref_z1,
                                              use_greedy=use_greedy)
        pop, (z1,) = multi.pbt_step(pop, [z1], use_greedy=use_greedy,
                                    draws=draws)
        np.testing.assert_allclose(pop.temperature.numpy(),
                                   np.asarray(ref_pop.temperature),
                                   rtol=1e-6)
        np.testing.assert_allclose(pop.best_latency.numpy(),
                                   np.asarray(ref_pop.best_latency),
                                   rtol=TOL)
        np.testing.assert_array_equal(pop.best_fine.numpy(),
                                      np.asarray(ref_pop.best_fine))
        np.testing.assert_allclose(z1.numpy(), np.asarray(ref_z1)[0],
                                   rtol=TOL, atol=TOL)
        ref_z, z = ref_z1, z1
    assert restarts == [False, True]


def test_population_search_runs_end_to_end(graph):
    """``search(population=...)`` in its dict form: culls and a greedy
    restart, the population's best never rises and is the search's best."""
    g, arrays = graph
    agent = HSDAG(HSDAGConfig(hidden_channel=HIDDEN, batch_chains=B,
                              update_timestep=T, max_episodes=3,
                              engine="level"), device="cpu")
    res = agent.search(g, arrays, platform=paper_platform(),
                       population={"cull_every": 1,
                                   "greedy_restart_every": 2})
    pop_best = [h["pop_best_latency"] for h in res.history]
    assert all(h["culled"] for h in res.history)
    assert all(b <= a for a, b in zip(pop_best, pop_best[1:]))
    assert pop_best[-1] == pytest.approx(res.best_latency, rel=TOL)
    assert all(0.2 <= h["temp_mean"] <= 3.0 for h in res.history)


def test_population_needs_the_batched_loop(graph):
    g, arrays = graph
    agent = HSDAG(HSDAGConfig(hidden_channel=HIDDEN, batch_chains=1),
                  device="cpu")
    with pytest.raises(ValueError, match="population search needs"):
        agent.search(g, arrays, platform=paper_platform(), engine="scalar",
                     population=PopulationConfig())
    with pytest.raises(TypeError, match="population must be"):
        HSDAG(HSDAGConfig(hidden_channel=HIDDEN, batch_chains=4),
              device="cpu").search(g, arrays, platform=paper_platform(),
                                   population=3)
