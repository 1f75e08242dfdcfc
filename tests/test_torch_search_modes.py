"""Port parity, the search's other modes: a ``k_epochs=2`` update with parse
dropout against the reference (the second epoch replays the window's draws
under the updated weights and derives its labels and actions anew), the
scalar engine against the batched loop at B=1 with a host reward (the
reference's scalar loop follows that trajectory, ``tests/test_hsdag_batch.py``),
and a sampled ``place()`` fed the reference's draws."""
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

from repro_torch.checkpoint import params_to_numpy, tree_from_tensors  # noqa: E402,E501
from repro_torch.core import (HSDAG, HSDAGConfig, extract_features,  # noqa: E402
                              paper_platform, simulate)
from repro_torch.core.sim import RewardPipeline  # noqa: E402

from conftest import random_dag  # noqa: E402
from test_torch_grad_precision import F32_RTOL  # noqa: E402
from test_torch_hsdag import TOL, _assert_trees_close, _noise  # noqa: E402

B, T, HIDDEN = 3, 3, 16
PARSE_DROPOUT = 0.2


@pytest.fixture(scope="module")
def graph():
    g = random_dag(np.random.default_rng(0), 24)
    return g, extract_features(g)


def _pair(arrays, **kw):
    """A reference agent and a port agent with the same initial weights."""
    ref = RefHSDAG(RefConfig(hidden_channel=HIDDEN, batch_chains=B,
                             update_timestep=T, engine="level",
                             max_episodes=1, **kw))
    params = ref.init(jax.random.PRNGKey(0), arrays)
    agent = HSDAG(HSDAGConfig.from_json(ref.cfg.to_json()), device="cpu")
    agent.load_params(jax.tree.map(np.asarray, params))
    return ref, agent


def _weights_agree(agent, ref):
    for a, b in zip(jax.tree.leaves(params_to_numpy(agent.policy)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_k_epochs_with_parse_dropout_match_the_reference(graph):
    """Two windows of ``k_epochs=2``, ``dropout_parsing=0.2``: placements
    and groups exact, rewards and states at 1e-5, each epoch's gradient and
    the weights after each update."""
    g, arrays = graph
    ref, agent = _pair(arrays, k_epochs=2, dropout_parsing=PARSE_DROPOUT)
    ref_pipe = RefPipeline.from_platform(g, ref_paper(), "level")
    ref_engine = ref._engine_single(arrays, ref_pipe)
    pipe = RewardPipeline.from_platform(g, paper_platform(), "level",
                                        device="cpu")
    engine = agent.rollout_engine(arrays)
    names = [n for n, _ in agent.policy.named_parameters()]

    rng = jax.random.PRNGKey(1)
    rngs = jnp.stack([rng] + [jax.random.fold_in(rng, b)
                              for b in range(1, B)])[None]
    x0 = jnp.asarray(arrays.x)
    ref_z = jnp.broadcast_to(x0, (1, B) + x0.shape)
    z = engine.x0.expand(B, *engine.x0.shape)
    for window in range(2):
        first = window == 0
        (ref_z1, rngs, keys, ref_fines, ref_ng, _, _) = \
            ref_engine.rollout_window(ref.params, ref_z, rngs, num_steps=T,
                                      start_first=first)
        ref_rew, _ = ref_pipe.score_window(np.asarray(ref_fines)[:, 0])
        noise = _noise(np.asarray(keys)[:, 0], arrays, 2, PARSE_DROPOUT)
        assert 0 < noise.parse_keep.mean() < 1
        z1, record, fines, ngroups = engine.rollout_window(
            z, num_steps=T, start_first=first, noise=noise)
        rewards, _ = pipe.score_window(fines)
        np.testing.assert_array_equal(fines.numpy(),
                                      np.asarray(ref_fines)[:, 0])
        np.testing.assert_array_equal(ngroups.numpy(),
                                      np.asarray(ref_ng)[:, 0])
        np.testing.assert_allclose(rewards, ref_rew, rtol=TOL)
        np.testing.assert_allclose(z1.numpy(), np.asarray(ref_z1)[0],
                                   rtol=TOL, atol=TOL)

        w = step_weights(ref_rew.T, ref.cfg.gamma).T
        for epoch in range(2):
            ref_grads = ref_engine.window_grads(
                ref.params, ref_z, keys, jnp.asarray(w)[:, None],
                num_steps=T, start_first=first)
            grads = engine.window_grads(z, record, torch.as_tensor(w.copy()),
                                        start_first=first,
                                        rederive=epoch > 0)
            _assert_trees_close(tree_from_tensors(names, grads),
                                jax.tree.map(np.asarray, ref_grads),
                                F32_RTOL, f"window {window} epoch {epoch}")
            ref.apply_grads(ref_grads)
            agent.apply_grads(grads)
            _weights_agree(agent, ref)
        ref_z, z = ref_z1, z1


def test_rederive_scores_what_the_new_weights_sample(graph):
    """With unchanged weights the re-derived replay is the recorded one;
    the record keeps every draw it needs."""
    g, arrays = graph
    _, agent = _pair(arrays, dropout_parsing=PARSE_DROPOUT)
    engine = agent.rollout_engine(arrays)
    from repro_torch.core.sim import ChainStreams
    z0 = engine.x0.expand(B, *engine.x0.shape)
    _, record, _, _ = engine.rollout_window(
        z0, num_steps=T, start_first=True,
        streams=ChainStreams(0, B, "cpu"))
    assert record.parse_keep.shape == record.keep.shape
    assert record.gumbel.shape == (T, B, g.num_nodes, 2)
    w = torch.ones(T, B)
    a = engine.window_grads(z0, record, w, start_first=True)
    b = engine.window_grads(z0, record, w, start_first=True, rederive=True)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _host_reward(g, plat):
    def reward_fn(p):
        r = simulate(g, p, plat)
        return r.reward, r.latency
    return reward_fn


def _search_one_chain(g, arrays, engine, k_epochs=1, **source):
    agent = HSDAG(HSDAGConfig(hidden_channel=HIDDEN, batch_chains=1,
                              update_timestep=T, max_episodes=3,
                              k_epochs=k_epochs, engine=engine),
                  device="cpu")
    return agent.search(g, arrays, **source)


def _same_search(a, b):
    for key in ("best_latency", "mean_reward", "mean_groups"):
        assert [h[key] for h in a.history] == [h[key] for h in b.history]
    np.testing.assert_array_equal(a.best_placement, b.best_placement)
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("k_epochs", [1, 2])
def test_scalar_loop_follows_the_batched_loop_at_one_chain(graph, k_epochs):
    """The scalar engine draws chain 0's stream and scores one placement at
    a time on the host: with the same host rewards it follows the batched
    loop at B=1 and ends at the same weights."""
    g, arrays = graph
    reward_fn = _host_reward(g, paper_platform())
    _same_search(
        _search_one_chain(g, arrays, "scalar", k_epochs, reward_fn=reward_fn),
        _search_one_chain(g, arrays, "batched", k_epochs,
                          reward_fn=reward_fn))


def test_scalar_engine_given_a_platform_scores_with_simulate(graph):
    """Given a platform, the scalar engine scores with the host
    ``simulate``, as the reference's scalar loop does."""
    g, arrays = graph
    plat = paper_platform()
    _same_search(
        _search_one_chain(g, arrays, "scalar", platform=plat),
        _search_one_chain(g, arrays, "batched",
                          reward_fn=_host_reward(g, plat)))


def test_scalar_engine_needs_one_chain(graph):
    g, arrays = graph
    agent = HSDAG(HSDAGConfig(hidden_channel=HIDDEN, batch_chains=2,
                              engine="scalar"), device="cpu")
    with pytest.raises(ValueError, match="batch_chains == 1"):
        agent.search(g, arrays, platform=paper_platform())


def test_sampled_place_matches_the_reference(graph):
    """``place(greedy=False)``'s step with the reference's draws (edge and
    parse dropout, Gumbel noise) places as the reference's sampled
    ``place``; the port's own draws give a valid, seeded placement."""
    g, arrays = graph
    ref, agent = _pair(arrays, dropout_parsing=PARSE_DROPOUT)
    key = jax.random.PRNGKey(3)
    want = ref.place(arrays, rng=key, greedy=False)
    noise = _noise(np.asarray(key)[None, None], arrays, 2, PARSE_DROPOUT)
    engine = agent.rollout_engine(arrays)
    _, _, fines, _ = engine.rollout_window(engine.x0[None], num_steps=1,
                                           start_first=True, noise=noise)
    np.testing.assert_array_equal(fines[0, 0].numpy(), want)

    sampled = agent.place(arrays, greedy=False)
    assert sampled.shape == (g.num_nodes,)
    assert set(np.unique(sampled)) <= {0, 1}
    again = agent.place(arrays, torch.Generator().manual_seed(0),
                        greedy=False)
    np.testing.assert_array_equal(sampled, again)
    np.testing.assert_array_equal(agent.place(arrays),
                                  ref.place(arrays, greedy=True))
