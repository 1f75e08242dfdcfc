"""Port parity, ``MeasuredExecutor`` (Table 4's measured half): the proxy
sizes and weights bitwise the reference's, and the final node's output
under two placements equal to the reference's to 1e-5 normwise, on CPU
devices."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import executor as refex  # noqa: E402

from repro_torch.core import executor as ex  # noqa: E402

from conftest import random_dag  # noqa: E402

#: normwise relative distance of the final outputs (f32 matvecs summed in
#: another order)
TOL = 1e-5


@pytest.fixture(scope="module")
def graph():
    return random_dag(np.random.default_rng(2), 30, 0.2)


@pytest.mark.parametrize("flops,elems", [(0.0, 1), (1e3, 4), (5e6, 300),
                                         (1e12, 1 << 20), (3e9, 2048)])
def test_proxy_dims_are_the_references(flops, elems):
    assert ex._proxy_dims(flops, elems) == refex._proxy_dims(flops, elems)


def test_proxy_weights_are_the_references_bitwise(graph):
    mine = ex.MeasuredExecutor(graph, devices=["cpu"])
    ref = refex.MeasuredExecutor(graph, devices=jax.devices("cpu"))
    assert mine._dims == ref._dims
    assert list(mine._weights) == list(ref._weights)
    for key, w in ref._weights.items():
        assert mine._weights[key].dtype == w.dtype
        np.testing.assert_array_equal(mine._weights[key].view(np.uint64),
                                      w.view(np.uint64))
    np.testing.assert_array_equal(mine.order, ref.order)
    assert mine.preds == ref.preds


def _ref_final(ref, placement, fill=0.0):
    """The reference's final output (``benchmarks/table4_downstream.py``'s
    walk of the DAG), each accumulator started from ``fill``."""
    import jax.numpy as jnp
    outs = [None] * ref.graph.num_nodes
    for v in ref.order:
        v = int(v)
        dev_idx = int(placement[v]) % len(ref.devices)
        dev = ref.devices[dev_idx]
        m, k = ref._dims[v]
        w = ref._weight_on(m, k, dev_idx)
        acc = jnp.full((k,), fill, jnp.float32, device=dev)
        for u in ref.preds[v]:
            x = outs[u]
            n = min(x.shape[0], k)
            acc = acc.at[:n].add(x[:n])
        outs[v] = ref._node_fn(w, acc)
    return np.asarray(outs[int(ref.order[-1])])


def test_final_outputs_match_the_reference(graph):
    """Two devices (both the CPU here), so the transfer path runs; the
    final output is the same whatever the placement.  The accumulators
    start from ones: from the reference's zeros every output is 0, and a
    wrong product, accumulation or transfer would pass unseen."""
    mine = ex.MeasuredExecutor(graph, devices=["cpu", "cpu"], warmup=1,
                               timed=2)
    ref = refex.MeasuredExecutor(graph, devices=jax.devices("cpu") * 2)
    rng = np.random.default_rng(0)
    outs = []
    for placement in (np.zeros(graph.num_nodes, np.int64),
                      rng.integers(0, 2, graph.num_nodes)):
        got = mine.outputs(placement, fill=1.0)[int(mine.order[-1])].numpy()
        want = _ref_final(ref, placement, fill=1.0)
        assert np.linalg.norm(want) > 0.1 * np.sqrt(want.size)
        assert np.linalg.norm(got - want) <= TOL * np.linalg.norm(want)
        outs.append(got)
        if len(outs) == 1:     # every distinct weight once, in float32
            assert mine.bytes_uploaded == sum(
                4 * m * k for m, k in mine._weights)
    np.testing.assert_array_equal(outs[0], outs[1])
    reward, latency = mine(np.zeros(graph.num_nodes, np.int64))
    assert latency > 0 and reward == pytest.approx(1.0 / latency)


def test_every_output_is_zero_from_the_references_accumulator(graph):
    """From the reference's zero accumulators every node outputs
    tanh(W·0) = 0, in both packages."""
    mine = ex.MeasuredExecutor(graph, devices=["cpu"])
    ref = refex.MeasuredExecutor(graph, devices=jax.devices("cpu"))
    placement = np.zeros(graph.num_nodes, np.int64)
    for out in mine.outputs(placement):
        assert not out.any()
    assert not _ref_final(ref, placement).any()


def test_default_devices_need_a_card(graph, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.MeasuredExecutor(graph)
