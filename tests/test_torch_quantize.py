"""Port parity, int8 weight-only serving (``repro_torch/models/quantize.py``
against ``repro/models/quantize.py``): ``quantize_tensor`` and
``dequantize`` bit for bit (ties at .5 included), the set of quantized
leaves on all ten SMOKE configs, a quantized model's forward, prefill and
decode against the reference's on the same ``QTensor`` tree, the weight
converter carrying a reference-quantized tree, the leaf-by-leaf build that
``launch.serve`` uses, and the reference's own bounds on the port.

Inputs come from numpy seeds or from the reference's ``init_params``,
carried across with ``lm_params_from_numpy``.  Tolerances: bitwise where
the arithmetic is the same IEEE f32 (``amax / 127``, ``w / scale``, round
half to even, the scale multiply); logits within the LM's 2e-5 (float32,
sums in another order across the frameworks).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get  # noqa: E402
from repro.models import decode_step as ref_decode_step  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import prefill as ref_prefill  # noqa: E402
from repro.models import quantize as ref_q  # noqa: E402

from repro_torch.checkpoint import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (ModelConfig, decode_step,  # noqa: E402
                                forward, init_params, lm, prefill)
from repro_torch.models import quantize as q  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

ARCHS = ["command-r-plus-104b", "h2o-danube-1.8b", "internvl2-76b",
         "jamba-1.5-large-398b", "mamba2-130m", "mixtral-8x22b",
         "musicgen-medium", "olmoe-1b-7b", "phi3-mini-3.8b", "qwen1.5-0.5b"]
# the serving parity's archs: attention with a window, the SSD mixer (its
# conv_w quantized), MoE (its f32 router quantized); jamba's reference
# compile, ~20 s, stays out
SERVE_ARCHS = ["h2o-danube-1.8b", "mamba2-130m", "olmoe-1b-7b"]
ATOL = 2e-5
BATCH, PROMPT, STEPS, CHUNK = 2, 13, 4, 4
# the reference's own test config (tests/test_quantize.py)
CFG = ModelConfig(name="q", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  d_ff=128, vocab_size=97, remat=False, dtype="float32")


def _ties(rng):
    """A (6, 5) weight whose column maxima are 127·2^k, so scales are exact
    powers of two, and whose other entries are n + 0.5 times the scale:
    every quotient lands on .5 and rounds half to even."""
    w = (rng.integers(-40, 40, (6, 5)) + 0.5).astype(np.float32)
    w[0] = 127.0
    return w * np.float32(2.0) ** rng.integers(-3, 3, 5).astype(np.float32)


@pytest.mark.parametrize("shape", [(32, 48), (3, 16, 8), (2, 3, 5, 7),
                                   (4, 1, 6), "ties"])
def test_quantize_tensor_matches_reference_bitwise(shape):
    rng = np.random.default_rng(0)
    if shape == "ties":
        w = _ties(rng)
        assert np.all(np.abs(w[1:] / (np.abs(w).max(0) / 127)) % 1 == 0.5)
    else:
        w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w[..., 1] = 0.0                      # an all-zero channel: scale 1
    want = ref_q.quantize_tensor(jnp.asarray(w))
    got = q.quantize_tensor(torch.from_numpy(w.copy()))
    assert got.data.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches_reference_bitwise(dtype, monkeypatch):
    """Also with slabs of 7 elements, the walk a large weight takes."""
    rng = np.random.default_rng(1)
    for shape in ((5, 9), (3, 4, 6), (2, 3, 5, 7)):
        w = rng.standard_normal(shape).astype(np.float32)
        qt = ref_q.quantize_tensor(jnp.asarray(w))
        want = np.asarray(ref_q.dequantize(qt, getattr(jnp, dtype))
                          .astype(jnp.float32))
        port = q.QTensor(torch.from_numpy(np.asarray(qt.data).copy()),
                         torch.from_numpy(np.asarray(qt.scale).copy()))
        for slab in (q.SLAB, 7):
            monkeypatch.setattr(q, "SLAB", slab)
            got = q.dequantize(port, getattr(torch, dtype))
            assert got.dtype == getattr(torch, dtype)
            assert np.array_equal(got.float().numpy(), want), (shape, slab)
            again = q.quantize_tensor(torch.from_numpy(w.copy()))
            assert torch.equal(again.data, port.data), (shape, slab)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_leaves_are_the_reference_s(arch):
    ref_cfg = ref_get(arch).smoke_config
    shapes = jax.eval_shape(lambda: ref_init_params(ref_cfg,
                                                    jax.random.PRNGKey(0)))
    want = sorted(
        "/".join(str(p) for p in path)
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
        if ref_q._should_quantize("/".join(str(p) for p in path), leaf))
    params = init_params(get(arch).smoke_config, device="cpu")
    assert q.quantized_paths(params) == tuple(want)
    qp = q.quantize_params(params, get(arch).smoke_config)
    assert sum(isinstance(x, q.QTensor) for x in tree_leaves(
        qp, is_leaf=lambda x: isinstance(x, q.QTensor))) == len(want)


def _ref_tree(arch):
    ref_cfg = ref_get(arch).smoke_config
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    return ref_cfg, ref_params, ref_q.quantize_params(ref_params, ref_cfg)


def _tokens(cfg, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (BATCH, s)).astype(np.int32)


@pytest.fixture(scope="module", params=SERVE_ARCHS)
def quantized(request):
    """(arch, ref cfg, ref QTensor tree, port cfg, the tree carried
    across)."""
    arch = request.param
    ref_cfg, _, ref_qp = _ref_tree(arch)
    cfg = get(arch).smoke_config
    tree = jax.tree.map(np.asarray, ref_qp)
    return arch, ref_cfg, ref_qp, cfg, lm_params_from_numpy(tree, cfg, "cpu")


def test_quantized_forward_prefill_and_decode_match_reference(quantized):
    arch, ref_cfg, ref_qp, cfg, qp = quantized
    toks = _tokens(cfg, PROMPT + STEPS, 1)
    want = np.asarray(ref_forward(ref_qp, ref_cfg, jnp.asarray(toks),
                                  ssd_chunk=CHUNK))
    got = forward(qp, cfg, torch.from_numpy(toks), ssd_chunk=CHUNK)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    prompt = toks[:, :PROMPT]
    ref_logits, ref_caches = ref_prefill(ref_qp, ref_cfg,
                                         jnp.asarray(prompt),
                                         ssd_chunk=CHUNK,
                                         max_len=PROMPT + STEPS)
    logits, caches = prefill(qp, cfg, torch.from_numpy(prompt),
                             ssd_chunk=CHUNK, max_len=PROMPT + STEPS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=0, atol=ATOL)
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    for i in range(STEPS):
        ref_logits, ref_caches = ref_decode_step(
            ref_qp, ref_cfg, jnp.asarray(tok.numpy()), ref_caches,
            jnp.int32(PROMPT + i))
        logits, caches = decode_step(qp, cfg, tok, caches, PROMPT + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=0, atol=ATOL, err_msg=f"step {i}")
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)


def test_a_reference_quantized_tree_carries_across(quantized):
    """The converter's QTensor leaves are bitwise the port's own
    ``quantize_params`` of the same weights, so both forward to the same
    logits."""
    arch, ref_cfg, _, cfg, carried = quantized
    _, ref_params, _ = _ref_tree(arch)
    own = q.quantize_params(lm_params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu"), cfg)
    is_q = lambda x: isinstance(x, q.QTensor)  # noqa: E731
    a, b = tree_leaves(carried, is_q), tree_leaves(own, is_q)
    assert [type(x) for x in a] == [type(x) for x in b]
    assert sum(map(is_q, a)) == len(q.quantized_paths(lm_params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu")))
    for x, y in zip(tree_leaves(carried), tree_leaves(own)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    toks = torch.from_numpy(_tokens(cfg, PROMPT, 2))
    assert torch.equal(forward(carried, cfg, toks, ssd_chunk=CHUNK),
                       forward(own, cfg, toks, ssd_chunk=CHUNK))


def test_the_converter_rejects_a_misshaped_quantized_leaf():
    cfg = get("h2o-danube-1.8b").smoke_config
    _, _, ref_qp = _ref_tree("h2o-danube-1.8b")
    tree = jax.tree.map(np.asarray, ref_qp)
    wq = tree["blocks"][0]["mixer"]["wq"]
    tree["blocks"][0]["mixer"]["wq"] = type(wq)(wq.data, wq.scale[:, :-1])
    with pytest.raises(ValueError, match="quantized leaf"):
        lm_params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "olmoe-1b-7b"])
def test_serve_builds_the_quantized_tree_leaf_by_leaf(arch, monkeypatch):
    """``init_quantized_params`` is ``quantize_params(init_params)`` bit for
    bit, every weight quantized as soon as it is drawn; ``serve`` uses it
    under ``quantize_weights`` and counts int8 plus scales."""
    cfg = dataclasses.replace(get(arch).smoke_config, quantize_weights=True)
    want = q.quantize_params(init_params(cfg, seed=0, device="cpu"), cfg)
    drawn = []
    real = q.quantize_tensor

    def spy(w):
        drawn.append(w.shape)
        return real(w)
    monkeypatch.setattr(q, "quantize_tensor", spy)
    got = q.init_quantized_params(cfg, seed=0, device="cpu")
    assert len(drawn) == len(q.quantized_paths(init_params(cfg,
                                                           device="cpu")))
    is_q = lambda x: isinstance(x, q.QTensor)  # noqa: E731
    assert [type(x) for x in tree_leaves(got, is_q)] == \
        [type(x) for x in tree_leaves(want, is_q)]
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    res = serve.serve(cfg, 2, 9, 3, "cpu")
    assert res.weight_bytes == sum(a.numel() * a.element_size()
                                   for a in tree_leaves(want))
    assert res.tokens.shape == (2, 3)


def test_blocks_dequantize_one_sublayer_at_a_time(monkeypatch):
    """A quantized tree stays int8: the block loop dequantizes one sub-layer
    (a position's mixer, then a dense FFN) of one repeat at a time, and an
    MoE layer its router and then one expert's slices at a time, never a
    whole position, repeat or tree."""
    from repro_torch.models import layers
    cfg = get("jamba-1.5-large-398b").smoke_config
    qp = q.quantize_params(init_params(cfg, device="cpu"), cfg)
    is_q = lambda x: isinstance(x, q.QTensor)  # noqa: E731
    want, moe = [], []
    for (_, ffn), b in zip(cfg.block_pattern, qp["blocks"]):
        want.append(sum(map(is_q, tree_leaves(b["mixer"], is_q))))
        if ffn == "dense":
            want.append(sum(map(is_q, tree_leaves(b["ffn"], is_q))))
        elif ffn == "moe":
            # the router, then each expert's three (d, f) / (f, d) slices
            moe += [tuple(b["ffn"]["router"].data.shape[1:])] + [
                tuple(b["ffn"][k].data.shape[2:])
                for _ in range(cfg.moe_experts)
                for k in ("w_gate", "w_up", "w_down")]
    trees, slices = [], []
    real_tree, real_one = lm.dequant_tree, layers.dequantize

    def spy_tree(tree, dtype):
        trees.append(sum(map(is_q, tree_leaves(tree, is_q))))
        return real_tree(tree, dtype)

    def spy_one(x, dtype):
        slices.append(tuple(x.data.shape) if is_q(x) else None)
        return real_one(x, dtype)
    monkeypatch.setattr(lm, "dequant_tree", spy_tree)
    monkeypatch.setattr(layers, "dequantize", spy_one)
    toks = torch.from_numpy(_tokens(cfg, 6, 3))
    forward(qp, cfg, toks, ssd_chunk=CHUNK)
    assert trees == want * cfg.pattern_repeats
    assert slices == moe * cfg.pattern_repeats


def test_reference_bounds_hold_in_the_port():
    """The reference's own checks (tests/test_quantize.py) on the port:
    the forward within 5 % of the unquantized one, decode within 2e-4 of
    the quantized forward, int8 under 1/2.5 of the f32 bytes, norms
    unquantized."""
    params = init_params(CFG, seed=0, device="cpu")
    qp = q.quantize_params(params, CFG)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 97, (2, 16)).astype(np.int32))
    base = forward(params, CFG, toks)
    out = forward(qp, CFG, toks)
    assert float((base - out).abs().max() / base.abs().max()) < 0.05
    orig = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    quant = sum(a.numel() * a.element_size() for a in tree_leaves(qp))
    assert quant < orig / 2.5
    assert not isinstance(qp["final_norm"], q.QTensor)
    assert not isinstance(qp["blocks"][0]["norm1"]["scale"], q.QTensor)
    assert isinstance(qp["blocks"][0]["mixer"]["wq"], q.QTensor)
    full = forward(qp, CFG, toks[:, :14])
    _, caches = prefill(qp, CFG, toks[:, :8], max_len=14)
    for t in range(8, 14):
        lg, caches = decode_step(qp, CFG, toks[:, t:t + 1], caches, t)
        assert float((lg[:, 0] - full[:, t]).abs().max()) < 2e-4, t
