"""Port parity, ``gcn_aggregate``: the plain edge-list version with one keep
mask per chain against the reference Pallas kernel (interpret mode) and the
reference dense formula, and the autograd function's backward; a repeated
edge row counted once, as the reference's binary adjacency counts it, through
the encoder, the GPN and one Alg.-1 step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HSDAG as RefHSDAG  # noqa: E402
from repro.core import HSDAGConfig as RefConfig  # noqa: E402
from repro.core.features import extract_features as ref_features  # noqa: E402
from repro.core.gnn import encoder_apply  # noqa: E402
from repro.core.gnn import normalize_adjacency as ref_normalize  # noqa: E402
from repro.kernels.gcn_spmm import gcn_aggregate as ref_gcn  # noqa: E402

from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.core.gnn import normalize_adjacency  # noqa: E402
from repro_torch.kernels import (GCNAggregate, gcn_aggregate,  # noqa: E402
                                 gcn_aggregate_ref, gcn_graph)

from conftest import random_dag  # noqa: E402

TOL = 1e-5


def _problem(v, f, chains, seed, dtype=np.float32):
    """Random DAG edges, per-chain 0/1 keep masks and features."""
    rng = np.random.default_rng(seed)
    upper = np.argwhere(np.triu(rng.random((v, v)) < 3.0 / v, k=1))
    edges = upper.astype(np.int32)
    keep = (rng.random((chains, len(edges))) < 0.8).astype(dtype)
    h = rng.standard_normal((chains, v, f)).astype(dtype)
    return edges, keep, h


def _masked_adj(edges, keep_row, v):
    adj = np.zeros((v, v), np.float32)
    adj[edges[:, 0], edges[:, 1]] = keep_row
    return adj


@pytest.mark.parametrize("v", [37, 133])
def test_gcn_ref_matches_reference_kernel_and_dense_formula(v):
    edges, keep, h = _problem(v, 64, chains=3, seed=v)
    graph = gcn_graph(edges, v, "cpu")
    launches = gcn_aggregate.launches
    got = gcn_aggregate(graph, torch.as_tensor(keep), torch.as_tensor(h))
    assert gcn_aggregate.launches == launches    # CPU tensors: plain version
    np.testing.assert_allclose(
        got.numpy(), gcn_aggregate_ref(graph, torch.as_tensor(keep),
                                       torch.as_tensor(h)).numpy(), rtol=0)
    for b in range(keep.shape[0]):
        adj = _masked_adj(edges, keep[b], v)
        want_kernel = np.asarray(ref_gcn(jnp.asarray(adj), jnp.asarray(h[b]),
                                         interpret=True))
        want_dense = np.asarray(ref_normalize(jnp.asarray(adj))
                                @ jnp.asarray(h[b]))
        np.testing.assert_allclose(got[b].numpy(), want_kernel, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got[b].numpy(), want_dense, rtol=TOL,
                                   atol=TOL)
    # The port's own dense formula is the reference's.
    adj0 = _masked_adj(edges, keep[0], v)
    np.testing.assert_allclose(
        normalize_adjacency(torch.as_tensor(adj0)).numpy(),
        np.asarray(ref_normalize(jnp.asarray(adj0))), rtol=TOL, atol=1e-7)


def test_gcn_backward_passes_gradcheck():
    edges, keep, h = _problem(12, 3, chains=2, seed=5, dtype=np.float64)
    graph = gcn_graph(edges, 12, "cpu")
    h = torch.as_tensor(h).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: GCNAggregate.apply(graph, torch.as_tensor(keep), x), (h,))


def test_gcn_backward_matches_autograd_through_dense_formula():
    v = 37
    edges, keep, h = _problem(v, 16, chains=2, seed=7)
    graph = gcn_graph(edges, v, "cpu")
    gout = torch.as_tensor(
        np.random.default_rng(8).standard_normal(h.shape).astype(np.float32))
    x = torch.as_tensor(h).requires_grad_(True)
    (got,) = torch.autograd.grad(
        GCNAggregate.apply(graph, torch.as_tensor(keep), x), x, gout)
    adj = torch.stack([torch.as_tensor(_masked_adj(edges, k, v))
                       for k in keep])
    y = torch.as_tensor(h).requires_grad_(True)
    (want,) = torch.autograd.grad(normalize_adjacency(adj) @ y, y, gout)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_gcn_graph_rejects_what_the_dense_adjacency_cannot_hold():
    with pytest.raises(ValueError, match="self loops"):
        gcn_graph(np.array([[1, 1]]), 3, "cpu")
    with pytest.raises(ValueError, match="edge ids"):
        gcn_graph(np.array([[0, 3]]), 3, "cpu")


def test_gcn_graph_counts_a_repeated_edge_row_once():
    """Repeated (src, dst) rows keep their first occurrence, in the order of
    first occurrence, one keep column each; a graph without repeats keeps
    its edge ids."""
    edges = np.array([[0, 1], [2, 3], [0, 1], [1, 2], [2, 3], [0, 1]])
    graph = gcn_graph(edges, 4, "cpu")
    assert graph.num_edges == 3
    np.testing.assert_array_equal(graph.src.numpy(), [0, 2, 1])
    np.testing.assert_array_equal(graph.dst.numpy(), [1, 3, 2])
    keep = np.array([[1, 0, 1], [0, 1, 1]], np.float32)
    h = np.random.default_rng(0).standard_normal((2, 4, 5)).astype(np.float32)
    got = gcn_aggregate(graph, torch.as_tensor(keep), torch.as_tensor(h))
    for b in range(2):
        adj = np.zeros((4, 4), np.float32)
        adj[edges[:, 0], edges[:, 1]] = 1.0          # binary, as the reference
        adj[[0, 2, 1], [1, 3, 2]] *= keep[b]
        want = np.asarray(ref_normalize(jnp.asarray(adj)) @ jnp.asarray(h[b]))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=TOL, atol=TOL)

    plain, _, _ = _problem(37, 4, chains=1, seed=3)
    graph = gcn_graph(plain, 37, "cpu")
    np.testing.assert_array_equal(graph.src.numpy(), plain[:, 0])
    np.testing.assert_array_equal(graph.dst.numpy(), plain[:, 1])


@pytest.mark.parametrize("first", [True, False])
def test_a_doubled_input_gives_the_references_encoder_gpn_and_step(first):
    """``add_op(..., inputs=[x, x])`` repeats an edge row.  The port's policy
    step, fed keep columns gathered from the reference's (V, V) dropout mask
    at the de-duplicated edges, gives the reference's encoder output, GPN
    labels and groups, placement, log-prob and next state."""
    g = random_dag(np.random.default_rng(6), 20)
    g.add_op("twice", "Add", ["n3", "n3"], (1, 8), flops=64.0,
             bytes_out=32.0)
    g.add_op("after", "MatMul", ["twice", "n7", "n7"], (1, 8), flops=1e5,
             bytes_out=32.0)
    arrays = ref_features(g)
    assert len(np.unique(arrays.edges, axis=0)) == len(arrays.edges) - 2
    ref = RefHSDAG(RefConfig(hidden_channel=16, batch_chains=1))
    params = ref.init(jax.random.PRNGKey(0), arrays)
    policy = params_from_numpy(jax.tree.map(np.asarray, params))
    graph = gcn_graph(arrays.edges, arrays.num_nodes, "cpu")
    assert graph.num_edges == len(arrays.edges) - 2

    x0 = jnp.asarray(arrays.x)
    z = (x0 if first else jnp.asarray(np.random.default_rng(9)
                                      .standard_normal((arrays.num_nodes, 16))
                                      .astype(np.float32)))
    key = jax.random.PRNGKey(11)
    out = ref._step(params, z, x0, jnp.asarray(arrays.adj),
                    jnp.asarray(arrays.edges), key, first=first, train=True)
    k_net, _, k_pol = jax.random.split(key, 3)
    dense = np.asarray(jax.random.bernoulli(k_net, 0.8, arrays.adj.shape))
    keep = dense[graph.src.numpy(), graph.dst.numpy()].astype(np.float32)
    gumbel = np.asarray(jax.random.gumbel(k_pol, out.policy.logits.shape))

    # The encoder against the reference's on the masked binary adjacency.
    want_enc = encoder_apply(params["enc"], z,
                             jnp.asarray(arrays.adj * dense), transform=first)
    zt = torch.tensor(np.asarray(z))[None]
    with torch.no_grad():
        enc = policy.enc(zt, graph, torch.as_tensor(keep)[None],
                         transform=first)
        mine = policy.step(zt, torch.as_tensor(arrays.x)[None], graph,
                           torch.as_tensor(keep)[None], first=first,
                           gumbel=torch.tensor(gumbel)[None])
    np.testing.assert_allclose(enc[0].numpy(), np.asarray(want_enc),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(mine.parse.labels[0].numpy(),
                                  np.asarray(out.parse.labels))
    assert int(mine.parse.num_groups[0]) == int(out.parse.num_groups)
    np.testing.assert_allclose(mine.parse.pooled_z[0].numpy(),
                               np.asarray(out.parse.pooled_z), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(mine.policy.fine_placement[0].numpy(),
                                  np.asarray(out.policy.fine_placement))
    np.testing.assert_allclose(mine.policy.logp[0].item(),
                               float(out.policy.logp), rtol=TOL)
    np.testing.assert_allclose(mine.z_next[0].numpy(), np.asarray(out.z_next),
                               rtol=TOL, atol=TOL)
