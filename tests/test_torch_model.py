"""Port parity, model: encoder, GPN, policy head, one Alg.-1 step and one
Adam step, with the reference's weights carried over by
``params_from_numpy`` and its random draws fed in."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HSDAG as RefHSDAG  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.core.features import extract_features as ref_features  # noqa: E402
from repro.core.gnn import encoder_apply  # noqa: E402
from repro.core.gpn import edge_scores as ref_edge_scores  # noqa: E402
from repro.core.gpn import parse_graph as ref_parse_graph  # noqa: E402
from repro.core.policy import policy_apply as ref_policy_apply  # noqa: E402
from repro.optim import adam as ref_adam  # noqa: E402

from repro_torch.checkpoint import (params_from_numpy,  # noqa: E402
                                    tree_from_tensors)
from repro_torch.core.gpn import edge_scores, parse_graph  # noqa: E402
from repro_torch.core.policy import policy_apply  # noqa: E402
from repro_torch.kernels import gcn_graph  # noqa: E402
from repro_torch.optim import Adam  # noqa: E402

from conftest import random_dag  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    g = random_dag(np.random.default_rng(2), 24)
    arrays = ref_features(g)
    cfg = RefConfig(hidden_channel=16, batch_chains=2)
    ref = RefHSDAG(cfg)
    params = ref.init(jax.random.PRNGKey(0), arrays)
    tree = jax.tree.map(np.asarray, params)
    policy = params_from_numpy(tree)
    graph = gcn_graph(arrays.edges, arrays.num_nodes, "cpu")
    return dict(g=g, arrays=arrays, cfg=cfg, ref=ref, params=params,
                policy=policy, graph=graph)


def _keep(key, arrays):
    """The reference's (V, V) edge-dropout mask, gathered at the edges."""
    dense = np.asarray(jax.random.bernoulli(key, 0.8, arrays.adj.shape))
    return dense[arrays.edges[:, 0], arrays.edges[:, 1]].astype(np.float32)


def test_params_round_trip(setup):
    back = tree_from_tensors(*zip(*setup["policy"].named_parameters()))
    want = jax.tree.map(np.asarray, setup["params"])
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("transform", [True, False])
def test_encoder_matches(setup, transform):
    arrays, policy = setup["arrays"], setup["policy"]
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    keep = np.stack([_keep(k, arrays) for k in keys])
    x = arrays.x if transform else np.random.default_rng(4).standard_normal(
        (arrays.num_nodes, 16)).astype(np.float32)
    with torch.no_grad():
        got = policy.enc(torch.as_tensor(x).expand(2, *x.shape),
                         setup["graph"], torch.as_tensor(keep),
                         transform=transform)
    for b in range(2):
        adj = np.zeros_like(arrays.adj)
        adj[arrays.edges[:, 0], arrays.edges[:, 1]] = keep[b]
        want = encoder_apply(setup["params"]["enc"], jnp.asarray(x),
                             jnp.asarray(adj), transform=transform)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)


def test_gpn_and_policy_match(setup):
    arrays, policy, params = setup["arrays"], setup["policy"], setup["params"]
    z = np.random.default_rng(5).standard_normal(
        (arrays.num_nodes, 16)).astype(np.float32)
    edges = jnp.asarray(arrays.edges)
    ref_s = ref_edge_scores(params["gpn"], jnp.asarray(z), edges)
    src, dst = setup["graph"].src, setup["graph"].dst
    zt = torch.as_tensor(z)[None]
    with torch.no_grad():
        s = edge_scores(policy.gpn, zt, src, dst)
    np.testing.assert_allclose(s[0].numpy(), np.asarray(ref_s), rtol=TOL,
                               atol=TOL)

    # Labels on the reference's own scores: `>=` ties at the dominant-edge
    # test make labels sensitive to ulp differences in the scores.
    ref_parse = ref_parse_graph(ref_s, edges, jnp.asarray(z),
                                jnp.asarray(arrays.adj))
    parse = parse_graph(torch.tensor(np.asarray(ref_s))[None], src, dst, zt)
    np.testing.assert_array_equal(parse.labels[0].numpy(),
                                  np.asarray(ref_parse.labels))
    assert int(parse.num_groups[0]) == int(ref_parse.num_groups)
    np.testing.assert_array_equal(parse.active[0].numpy(),
                                  np.asarray(ref_parse.active))
    np.testing.assert_array_equal(parse.retained[0].numpy(),
                                  np.asarray(ref_parse.retained))
    np.testing.assert_allclose(parse.pooled_z[0].numpy(),
                               np.asarray(ref_parse.pooled_z), rtol=TOL,
                               atol=TOL)

    # Policy: logits, and the sample under the reference's Gumbel noise
    # (jax.random.categorical is argmax(logits + gumbel(key))).
    k_pol = jax.random.PRNGKey(6)
    ref_pol = ref_policy_apply(params["pol"], ref_parse.pooled_z,
                               ref_parse.active, ref_parse.labels, k_pol)
    gumbel = np.asarray(jax.random.gumbel(k_pol, ref_pol.logits.shape))
    with torch.no_grad():
        pol = policy_apply(policy.pol, parse.pooled_z, parse.active,
                           parse.labels, gumbel=torch.tensor(gumbel)[None])
    np.testing.assert_allclose(pol.logits[0].numpy(),
                               np.asarray(ref_pol.logits), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(pol.coarse_placement[0].numpy(),
                                  np.asarray(ref_pol.coarse_placement))
    np.testing.assert_array_equal(pol.fine_placement[0].numpy(),
                                  np.asarray(ref_pol.fine_placement))
    np.testing.assert_allclose(pol.logp[0].item(), float(ref_pol.logp),
                               rtol=TOL)
    np.testing.assert_allclose(pol.entropy[0].item(), float(ref_pol.entropy),
                               rtol=TOL)


@pytest.mark.parametrize("first", [True, False])
def test_one_step_matches(setup, first):
    """One whole Alg.-1 iteration (``HSDAG._step``), training draws fed in,
    including the state update and its RMS normalisation."""
    arrays, policy, ref = setup["arrays"], setup["policy"], setup["ref"]
    x0 = jnp.asarray(arrays.x)
    z = (x0 if first else jnp.asarray(np.random.default_rng(9)
                                      .standard_normal((arrays.num_nodes, 16))
                                      .astype(np.float32)))
    key = jax.random.PRNGKey(11)
    out = ref._step(setup["params"], z, x0, jnp.asarray(arrays.adj),
                    jnp.asarray(arrays.edges), key, first=first, train=True)
    k_net, _, k_pol = jax.random.split(key, 3)
    keep = _keep(k_net, arrays)
    gumbel = np.asarray(jax.random.gumbel(k_pol, out.policy.logits.shape))
    with torch.no_grad():
        mine = policy.step(torch.tensor(np.asarray(z))[None],
                           torch.as_tensor(arrays.x)[None], setup["graph"],
                           torch.as_tensor(keep)[None], first=first,
                           gumbel=torch.tensor(gumbel)[None])
    np.testing.assert_array_equal(mine.parse.labels[0].numpy(),
                                  np.asarray(out.parse.labels))
    np.testing.assert_array_equal(mine.policy.fine_placement[0].numpy(),
                                  np.asarray(out.policy.fine_placement))
    np.testing.assert_allclose(mine.policy.logp[0].item(),
                               float(out.policy.logp), rtol=TOL)
    np.testing.assert_allclose(mine.z_next[0].numpy(), np.asarray(out.z_next),
                               rtol=TOL, atol=TOL)


def test_adam_steps_match():
    rng = np.random.default_rng(12)
    shapes = [(5, 3), (3,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt = ref_adam(1e-3)
    ref_p = [jnp.asarray(p) for p in params]
    state = opt.init(ref_p)
    mine = [torch.as_tensor(p.copy()) for p in params]
    adam = Adam(mine, 1e-3)
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        updates, state = opt.update([jnp.asarray(g) for g in grads], state,
                                    ref_p)
        ref_p = [p + u for p, u in zip(ref_p, updates)]
        adam.update([torch.as_tensor(g) for g in grads])
    for a, b in zip(mine, ref_p):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
