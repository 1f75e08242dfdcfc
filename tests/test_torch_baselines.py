"""Port parity, Table 2's learned baselines: ``PlacetoBaseline`` and
``RNNBaseline`` against the reference's on small random DAGs — the initial
weights bitwise (the RNN's normal draws too), Placeto's forward logits, the
log-probabilities of placements the reference sampled from its keys, and
two episodes of search fed the reference's recorded placements: the
rewards, the best placement and its latency exact, the weights at the
port's gradient tolerances."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import extract_features as ref_extract  # noqa: E402
from repro.core import paper_platform as ref_paper  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core import baselines as refb  # noqa: E402
from repro.core.gnn import encoder_apply, mlp_apply  # noqa: E402

from repro_torch.checkpoint import (params_to_numpy,  # noqa: E402
                                    tree_from_tensors)
from repro_torch.core import FeatureConfig, extract_features  # noqa: E402
from repro_torch.core import baselines as b  # noqa: E402

from conftest import random_dag  # noqa: E402
from test_torch_hsdag import (GRAD_RTOL, TOL,  # noqa: E402
                             _assert_trees_close, _at)

#: the RNN's weights after two episodes: its gradient runs through a
#: recurrence over every node (``test_torch_grad_precision.py``'s F32_RTOL)
RNN_RTOL = 2e-4
METHODS = {"placeto": (refb.PlacetoBaseline, b.PlacetoBaseline),
           "rnn": (refb.RNNBaseline, b.RNNBaseline)}


def _cfg(**kw):
    kw = {"num_devices": 2, "hidden": 16, "learning_rate": 1e-2,
          "episodes": 2, "samples_per_episode": 3, "seed": 3, **kw}
    return refb.BaselineConfig(**kw), b.BaselineConfig(**kw)


@pytest.fixture(scope="module")
def graph():
    g = random_dag(np.random.default_rng(5), 14, 0.25)
    fc = FeatureConfig(d_pos=16)
    return g, extract_features(g, fc), ref_extract(g, fc)


def _ref_init(cls, cfg, arrays, seed):
    agent = cls(cfg)
    agent.init(jax.random.split(jax.random.PRNGKey(seed))[1], arrays)
    return agent


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("seed", [0, 3])
def test_init_is_the_reference_init_bitwise(graph, method, seed):
    _, arrays, ref_arrays = graph
    ref_cls, cls = METHODS[method]
    ref_cfg, cfg = _cfg(seed=seed)
    ref = _ref_init(ref_cls, ref_cfg, ref_arrays, seed)
    agent = cls(cfg, device="cpu")
    agent.init(arrays)
    mine, want = params_to_numpy(agent.model), ref.params
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(mine)
    for a, w in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert a.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), w.view(np.uint32))


def test_placeto_forward_logits_match(graph):
    _, arrays, ref_arrays = graph
    ref_cfg, cfg = _cfg()
    ref = _ref_init(refb.PlacetoBaseline, ref_cfg, ref_arrays, 3)
    agent = b.PlacetoBaseline(cfg, device="cpu")
    agent.init(arrays)
    want = mlp_apply(ref.params["head"],
                     encoder_apply(ref.params["enc"],
                                   jnp.asarray(ref_arrays.x),
                                   jnp.asarray(ref_arrays.adj)))
    with torch.no_grad():
        got = agent.logits(agent._prepare(arrays)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def _ref_samples(method, ref, ref_arrays, n):
    """``n`` placements the reference samples from its keys, and their
    summed log-probabilities."""
    keys = jax.random.split(jax.random.PRNGKey(11), n)
    if method == "placeto":
        logits = mlp_apply(ref.params["head"],
                           encoder_apply(ref.params["enc"],
                                         jnp.asarray(ref_arrays.x),
                                         jnp.asarray(ref_arrays.adj)))
        logp_full = jax.nn.log_softmax(logits, -1)
        out = []
        for k in keys:
            p = jax.random.categorical(k, logits, axis=-1)
            out.append((np.asarray(p, np.int64), float(jnp.take_along_axis(
                logp_full, p[:, None], -1).sum())))
        return out
    order = np.argsort(ref_arrays.topo_pos)
    x_seq = jnp.asarray(ref_arrays.x[order])
    out = []
    for k in keys:
        choices, logp = ref._forward(ref.params, x_seq, k)
        p = np.empty(ref_arrays.num_nodes, np.int64)
        p[order] = np.asarray(choices)
        out.append((p, float(logp)))
    return out


@pytest.mark.parametrize("method", sorted(METHODS))
def test_log_probs_of_the_references_samples_match(graph, method):
    """The replay's log-probabilities on placements the reference sampled
    (``jax.random.categorical`` on its keys; the RNN teacher-forced)."""
    _, arrays, ref_arrays = graph
    ref_cls, cls = METHODS[method]
    ref_cfg, cfg = _cfg()
    ref = _ref_init(ref_cls, ref_cfg, ref_arrays, 3)
    agent = cls(cfg, device="cpu")
    agent.init(arrays)
    samples = _ref_samples(method, ref, ref_arrays, 3)
    placements = np.stack([p for p, _ in samples])
    with torch.no_grad():
        got = agent.log_probs(agent._prepare(arrays), placements)
    if method == "placeto":
        got = got[0]
    np.testing.assert_allclose(got.numpy(), [lp for _, lp in samples],
                               rtol=TOL, atol=0)


class _RefOptSpy:
    """The reference's optimizer, recording the gradient of each step."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads.append(jax.tree.map(np.asarray, grads))
        return self.opt.update(grads, state, params)


def _drop_attn_bias(tree):
    return {k: v for k, v in tree.items() if k != "attn"} | (
        {"attn": [{"w": layer["w"]} for layer in tree["attn"]]}
        if "attn" in tree else {})


@pytest.mark.parametrize("method", sorted(METHODS))
def test_two_episodes_on_the_references_placements_match(graph, method,
                                                         monkeypatch):
    """Two episodes (S=3) fed the placements the reference sampled: the
    same rewards, best placement and latency; each episode's gradient at
    the gradient tolerance (5e-5 for Placeto, 2e-4 for the RNN's
    recurrence) relative to each leaf's largest entry, and the weights after
    two Adam steps within ``TOL`` or that tolerance (Adam moves an entry
    whose gradient is near zero by a full step, so a bias that starts at
    zero is held to ``TOL``, a weight matrix to its scale).

    The RNN's attention bias adds one vector to every key, which shifts
    all of a step's scores by one number and leaves the softmax as it is:
    its true gradient is zero, and each side's is rounding noise, which
    Adam scales to full steps.  So it is held to be noise on both sides
    (below 1e-5 of the largest gradient) and left out of the weights."""
    g, arrays, ref_arrays = graph
    ref_cls, cls = METHODS[method]
    ref_cfg, cfg = _cfg(learning_rate=1e-4)
    plat = ref_paper()
    seen = []

    def ref_reward(p):
        seen.append(np.asarray(p, np.int64).copy())
        res = ref_simulate(g, p, plat)
        return res.reward, res.latency

    ref = ref_cls(ref_cfg)
    spy = ref._opt = _RefOptSpy(ref._opt)
    ref_res = ref.search(g, ref_arrays, ref_reward,
                         rng=jax.random.PRNGKey(cfg.seed))
    s = cfg.samples_per_episode
    episodes = [np.stack(seen[i:i + s]) for i in range(0, len(seen), s)]
    assert len(episodes) == cfg.episodes
    fed = iter(episodes)
    monkeypatch.setattr(cls, "_sample_episode",
                        lambda self, state, gen: next(fed))
    grads = []
    update = b.Adam.update

    def spy_update(self, gs):
        grads.append([t.detach().clone() for t in gs])
        return update(self, gs)
    monkeypatch.setattr(b.Adam, "update", spy_update)

    def reward(p):
        res = ref_simulate(g, p, plat)
        return res.reward, res.latency

    agent = cls(cfg, device="cpu")
    res = agent.search(g, arrays, reward)
    np.testing.assert_array_equal(res.best_placement, ref_res.best_placement)
    assert res.best_latency == ref_res.best_latency
    assert [h["mean_reward"] for h in res.history] == \
        [h["mean_reward"] for h in ref_res.history]
    assert [h["best_latency"] for h in res.history] == \
        [h["best_latency"] for h in ref_res.history]
    names = [n for n, _ in agent.model.named_parameters()]
    rtol = GRAD_RTOL if method == "placeto" else RNN_RTOL
    for ep, (mine, want) in enumerate(zip(grads, spy.grads)):
        mine = tree_from_tensors(names, mine)
        if method == "rnn":
            top = max(float(np.abs(x).max()) for x in jax.tree.leaves(want))
            for tree in (mine, want):
                assert np.abs(tree["attn"][0]["b"]).max() <= 1e-5 * top
            mine, want = _drop_attn_bias(mine), _drop_attn_bias(want)
        _assert_trees_close(mine, want, rtol, f"{method} episode {ep} grads")
    mine = params_to_numpy(agent.model)
    want = jax.tree.map(np.asarray, ref_res.params)
    if method == "rnn":
        mine, want = _drop_attn_bias(mine), _drop_attn_bias(want)
    for path, a in jax.tree_util.tree_leaves_with_path(mine):
        w = _at(want, path)
        err = float(np.abs(a - w).max())
        assert err <= max(TOL, rtol * float(np.abs(w).max())), \
            (method, jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_search_samples_on_its_own_and_keeps_the_best(graph, method):
    """The port's own sampling: S placements an episode in range, the best
    the lowest latency seen (starting from cpu_only), reproducible from the
    seed."""
    g, arrays, _ = graph
    _, cls = METHODS[method]
    _, cfg = _cfg(episodes=2)
    plat = ref_paper()
    lats = []

    def reward(p):
        assert p.shape == (g.num_nodes,) and p.min() >= 0 and p.max() < 2
        res = ref_simulate(g, p, plat)
        lats.append(res.latency)
        return res.reward, res.latency

    res = cls(cfg, device="cpu").search(g, arrays, reward)
    assert len(lats) == cfg.episodes * cfg.samples_per_episode
    assert res.best_latency == min(lats)
    assert ref_simulate(g, res.best_placement, plat).latency == \
        res.best_latency
    again = cls(cfg, device="cpu").search(g, arrays, reward)
    np.testing.assert_array_equal(again.best_placement, res.best_placement)


def test_lstm_cell_with_the_forget_offset_is_the_references_step():
    """``torch.lstm_cell`` with the +1 forget offset as its second bias is
    the reference's ``_lstm_step`` (one bias, ``sigmoid(f + 1)``) to
    ``TOL``, on the reference's weights with a nonzero bias."""
    rng = np.random.default_rng(4)
    d_in, d_h, rows = 7, 16, 3
    tree = refb._lstm_init(jax.random.PRNGKey(1), d_in, d_h)
    tree = {**jax.tree.map(np.asarray, tree),
            "b": rng.standard_normal(4 * d_h).astype(np.float32)}
    cell = b.LSTMCell(d_in, d_h)
    with torch.no_grad():
        cell.wx.copy_(torch.from_numpy(tree["wx"].T.copy()))
        cell.wh.copy_(torch.from_numpy(tree["wh"].T.copy()))
        cell.b.copy_(torch.from_numpy(tree["b"]))
    x, h, c = (rng.standard_normal((rows, d)).astype(np.float32)
               for d in (d_in, d_h, d_h))
    (want_h, want_c), _ = refb._lstm_step(tree, (h, c), x)
    with torch.no_grad():
        got_h, got_c = cell.step(*map(torch.from_numpy, (x, h, c)))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=TOL)
