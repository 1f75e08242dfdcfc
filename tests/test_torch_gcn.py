"""Port parity, ``gcn_aggregate``: the plain edge-list version with one keep
mask per chain against the reference Pallas kernel (interpret mode) and the
reference dense formula, and the autograd function's backward."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.gnn import normalize_adjacency as ref_normalize  # noqa: E402
from repro.kernels.gcn_spmm import gcn_aggregate as ref_gcn  # noqa: E402

from repro_torch.core.gnn import normalize_adjacency  # noqa: E402
from repro_torch.kernels import (GCNAggregate, gcn_aggregate,  # noqa: E402
                                 gcn_aggregate_ref, gcn_graph)

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
    with pytest.raises(ValueError, match="repeated"):
        gcn_graph(np.array([[0, 1], [0, 1]]), 3, "cpu")
    with pytest.raises(ValueError, match="self loops"):
        gcn_graph(np.array([[1, 1]]), 3, "cpu")
    with pytest.raises(ValueError, match="edge ids"):
        gcn_graph(np.array([[0, 3]]), 3, "cpu")
