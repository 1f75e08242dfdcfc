"""Port parity, the GraphSAGE encoder: ``sage_aggregate``'s plain version
and its autograd function against the reference's dense formula, forward and
backward; the encoder against the reference's ``encoder_apply``; a window,
its gradient and update, and a search with ``gnn_model="sage"``; and a SAGE
policy saved by the reference, loaded and decoded by the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_policy as ref_restore_policy  # noqa: E402
from repro.checkpoint import save_policy as ref_save_policy  # noqa: E402
from repro.core import HSDAG as RefHSDAG  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.core.gnn import encoder_apply  # noqa: E402

from repro_torch.checkpoint import (load_reference_policy,  # noqa: E402
                                    params_from_numpy, params_to_numpy)
from repro_torch.core import (HSDAG, HSDAGConfig, extract_features,  # noqa: E402
                              paper_platform, simulate)
from repro_torch.kernels import (SageAggregate, gcn_graph,  # noqa: E402
                                 sage_aggregate, sage_aggregate_ref)

from conftest import random_dag  # noqa: E402
from test_torch_hsdag import (_windows_match_the_reference,  # noqa: E402
                              TOL)

HIDDEN = 16


def _ref_sage_mean(adj, z):
    """The reference encoder's SAGE neighbour mean on one chain's dropped
    adjacency (``repro/core/gnn.py``)."""
    deg = jnp.clip(adj.sum(0) + adj.sum(1), 1.0)
    return ((adj + adj.T) @ z) / deg[:, None]


def _problem(v, f, chains, seed):
    rng = np.random.default_rng(seed)
    edges = np.argwhere(np.triu(rng.random((v, v)) < 3.0 / v, k=1))
    keep = (rng.random((chains, len(edges))) < 0.8).astype(np.float32)
    h = rng.standard_normal((chains, v, f)).astype(np.float32)
    g = rng.standard_normal((chains, v, f)).astype(np.float32)
    return edges, keep, h, g


@pytest.mark.parametrize("v,f", [(37, 16), (133, 40)])
def test_sage_ref_and_its_gradient_match_the_dense_formula(v, f):
    edges, keep, h, gout = _problem(v, f, chains=3, seed=v)
    graph = gcn_graph(edges, v, "cpu")
    launches = sage_aggregate.launches
    ht = torch.tensor(h, requires_grad=True)
    out = SageAggregate.apply(graph, torch.as_tensor(keep), ht)
    (grad,) = torch.autograd.grad(out, ht, torch.as_tensor(gout))
    assert sage_aggregate.launches == launches   # CPU: the plain version
    np.testing.assert_array_equal(
        out.detach().numpy(),
        sage_aggregate_ref(graph, torch.as_tensor(keep),
                           torch.as_tensor(h)).numpy())
    for b in range(keep.shape[0]):
        adj = np.zeros((v, v), np.float32)
        adj[edges[:, 0], edges[:, 1]] = keep[b]
        want, vjp = jax.vjp(lambda z: _ref_sage_mean(jnp.asarray(adj), z),
                            jnp.asarray(h[b]))
        (want_grad,) = vjp(jnp.asarray(gout[b]))
        np.testing.assert_allclose(out[b].detach().numpy(),
                                   np.asarray(want), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(grad[b].numpy(), np.asarray(want_grad),
                                   rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def setup():
    g = random_dag(np.random.default_rng(0), 24)
    arrays = extract_features(g)
    ref = RefHSDAG(RefConfig(hidden_channel=HIDDEN, batch_chains=2,
                             update_timestep=3, engine="level",
                             max_episodes=1, gnn_model="sage"))
    params = ref.init(jax.random.PRNGKey(0), arrays)
    return dict(g=g, arrays=arrays, ref=ref, params=params)


def test_sage_encoder_matches_the_reference(setup):
    arrays, params = setup["arrays"], setup["params"]
    tree = jax.tree.map(np.asarray, params)
    policy = params_from_numpy(tree)
    assert policy.enc.gnn_model == "sage"
    # the port's tree maps back to the reference's, leaf for leaf
    mine = params_to_numpy(policy)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    graph = gcn_graph(arrays.edges, arrays.num_nodes, "cpu")
    rng = np.random.default_rng(1)
    keep = (rng.random((3, graph.num_edges)) < 0.8).astype(np.float32)
    x = torch.as_tensor(arrays.x)
    with torch.no_grad():
        got = policy.enc(x.expand(3, *x.shape), graph, torch.as_tensor(keep))
    src, dst = arrays.edges[:, 0], arrays.edges[:, 1]
    for b in range(3):
        adj = np.zeros_like(arrays.adj)
        adj[src, dst] = keep[b]
        want = encoder_apply(params["enc"], jnp.asarray(arrays.x),
                             jnp.asarray(adj))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)


def test_a_sage_window_and_update_match_the_reference(setup):
    """One window, its gradient and the update.  (A second window is ill
    conditioned on this DAG: after the update chain 0's edge scores lie so
    close together that the reference's batched rollout and its own
    per-chain ``_step`` parse the same state differently; the port's parse
    is the per-chain step's.)"""
    g, arrays, ref = setup["g"], setup["arrays"], setup["ref"]
    ref = RefHSDAG(ref.cfg)
    params = ref.init(jax.random.PRNGKey(0), arrays)
    agent = HSDAG(HSDAGConfig.from_json(ref.cfg.to_json()), device="cpu")
    agent.load_params(jax.tree.map(np.asarray, params))
    _windows_match_the_reference(g, arrays, ref, agent, "level", 1)


def test_a_sage_search_runs_end_to_end(setup):
    g, arrays = setup["g"], setup["arrays"]
    agent = HSDAG(HSDAGConfig(hidden_channel=HIDDEN, batch_chains=2,
                              update_timestep=3, max_episodes=2,
                              gnn_model="sage"), device="cpu")
    res = agent.search(g, arrays, platform=paper_platform())
    assert len(res.history) == 2
    host = simulate(g, res.best_placement, paper_platform()).latency
    assert res.best_latency == pytest.approx(host, rel=TOL)
    assert {n for n, _ in agent.policy.named_parameters()} >= {
        "enc.gnn.0.w_self", "enc.gnn.0.w_nbr"}


def test_place_from_a_reference_sage_checkpoint(setup, tmp_path):
    arrays = setup["arrays"]
    ref = RefHSDAG(setup["ref"].cfg)
    params = ref.init(jax.random.PRNGKey(7), arrays)
    ref_save_policy(str(tmp_path), params, step=2,
                    meta={"config": ref.cfg.to_json()})
    tree, manifest = load_reference_policy(str(tmp_path))
    agent = HSDAG(HSDAGConfig.from_json(manifest["config"]), device="cpu")
    agent.load_params(tree)
    restored = RefHSDAG(ref.cfg)
    restored.init(jax.random.PRNGKey(0), arrays)
    restored.params, _, step, _ = ref_restore_policy(str(tmp_path),
                                                     restored.params)
    assert step == 2
    placement = agent.place(arrays)
    np.testing.assert_array_equal(placement, restored.place(arrays))
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
