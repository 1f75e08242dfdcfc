"""Port parity, the reference's two attention options on the CPU:
``attn_logit_softcap`` (the scaled scores capped at ``cap·tanh(s / cap)``
before the mask, in prefill and decode) and ``attn_head_merge`` (prefill
self-attention with (batch × heads) merged), alone and together, on
h2o-danube-1.8b's SMOKE config (GQA, 4 heads over 2, window 8): the
attention layer against the reference's ``attention``, the whole forward,
prefill and greedy decode, and a train step against
``jax.value_and_grad``; and the reference's rule that the merged prefill is
uncapped while decode caps.  The plain flash version takes the cap too
(the reference's Pallas kernel has none, so its ground truth is the
reference's plain ``attention``).

The SMOKE weights give scaled scores of order 1, so a cap of 1 bites: the
tests check the share of scores past cap / 2 and that capping moves the
outputs far past the tolerance.  Tolerances (float32): the layer 1e-5,
logits 2e-5, the loss 1e-5 relative and gradient leaves 1e-4 normwise (the
LM and training tests' bounds).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get  # noqa: E402
from repro.models import cross_entropy as ref_cross_entropy  # noqa: E402
from repro.models import decode_step as ref_decode_step  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import prefill as ref_prefill  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402

from repro_torch.checkpoint import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import flash_attention_ref  # noqa: E402
from repro_torch.models import (cross_entropy, decode_step,  # noqa: E402
                                forward, layers, prefill)
from repro_torch.models.lm import _value_and_grad  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

ARCH = "h2o-danube-1.8b"
CAP = 1.0
OPTIONS = {"softcap": {"attn_logit_softcap": CAP},
           "merge": {"attn_head_merge": True},
           "merge+softcap": {"attn_logit_softcap": CAP,
                             "attn_head_merge": True}}
LAYER_ATOL, ATOL = 1e-5, 2e-5
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
BATCH, PROMPT, STEPS = 2, 13, 4


@pytest.fixture(scope="module")
def weights():
    """The reference's SMOKE weights, and the same as numpy leaves."""
    ref_params = ref_init_params(ref_get(ARCH).smoke_config,
                                 jax.random.PRNGKey(0))
    return ref_params, jax.tree.map(np.asarray, ref_params)


def _models(weights, option):
    ref_params, tree = weights
    change = OPTIONS[option]
    ref_cfg = dataclasses.replace(ref_get(ARCH).smoke_config, **change)
    cfg = dataclasses.replace(get(ARCH).smoke_config, **change)
    return ref_cfg, ref_params, cfg, lm_params_from_numpy(tree, cfg, "cpu")


def _tokens(cfg, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (BATCH, s)).astype(np.int32)


def _layer(weights, cfg):
    """The first attention layer's weights (repeat 0) on both sides, and an
    input of unit-variance rows."""
    ref_params, tree = weights
    pos = [m for m, _ in cfg.block_pattern].index("attn")
    ref_p = jax.tree.map(lambda a: a[0], ref_params["blocks"][pos]["mixer"])
    p = {k: torch.from_numpy(np.asarray(v).copy())
         for k, v in ref_p.items()}
    x = np.random.default_rng(4).standard_normal(
        (BATCH, PROMPT, cfg.d_model)).astype(np.float32)
    return ref_p, p, x


@pytest.mark.parametrize("option", list(OPTIONS))
def test_attention_layer_matches_reference(weights, option):
    ref_cfg, _, cfg, _ = _models(weights, option)
    ref_p, p, x = _layer(weights, cfg)
    positions = np.broadcast_to(np.arange(PROMPT, dtype=np.int32),
                                (BATCH, PROMPT))
    want, _ = ref_layers.attention(ref_p, jnp.asarray(x), ref_cfg,
                                   positions=jnp.asarray(positions))
    got, _ = layers.attention(p, torch.from_numpy(x), cfg,
                              positions=torch.from_numpy(positions.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LAYER_ATOL)
    # the cap bites: a third of the scaled scores lie past cap / 2, and the
    # capped layer is far from the uncapped one (the merged path is
    # uncapped, as the reference's)
    q, k, _ = layers._project_qkv(p, torch.from_numpy(x), cfg,
                                  torch.from_numpy(positions.copy()))
    s = layers._gqa_scores(q, k, 1 / np.sqrt(cfg.head_dim_))
    assert float((s.abs() > CAP / 2).float().mean()) > 1 / 3
    plain = dataclasses.replace(cfg, attn_logit_softcap=0.0,
                                attn_head_merge=False)
    uncapped, _ = layers.attention(p, torch.from_numpy(x), plain,
                                   positions=torch.from_numpy(
                                       positions.copy()))
    dist = float((got - uncapped).abs().max())
    if option == "softcap":
        assert dist > 100 * LAYER_ATOL, dist
    else:
        assert dist < 1e-6, dist


def test_the_plain_flash_version_caps_like_the_reference_scores():
    """``flash_attention_ref`` with a cap against the reference's
    ``_gqa_scores`` + ``_attend`` on the same q, k, v, causal with a
    window."""
    rng = np.random.default_rng(6)
    b, h, kv, s, d, w = 2, 4, 2, 11, 8, 5
    q = rng.standard_normal((b, h, s, d)).astype(np.float32) * 2
    k = rng.standard_normal((b, kv, s, d)).astype(np.float32) * 2
    v = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = jnp.asarray((j <= i) & (j > i - w))[None, None, None]
    scores = ref_layers._gqa_scores(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)), 1 / np.sqrt(d), CAP)
    want = ref_layers._attend(scores, jnp.asarray(v.transpose(0, 2, 1, 3)),
                              mask)
    got = flash_attention_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                              window=w, softcap=CAP)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                               np.asarray(want), rtol=0, atol=LAYER_ATOL)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_forward_prefill_and_decode_match_reference(weights, option):
    ref_cfg, ref_params, cfg, params = _models(weights, option)
    toks = _tokens(cfg, PROMPT + STEPS, 1)
    want = np.asarray(ref_forward(ref_params, ref_cfg, jnp.asarray(toks)))
    got = forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    prompt = toks[:, :PROMPT]
    ref_logits, ref_caches = ref_prefill(ref_params, ref_cfg,
                                         jnp.asarray(prompt),
                                         max_len=PROMPT + STEPS)
    logits, caches = prefill(params, cfg, torch.from_numpy(prompt),
                             max_len=PROMPT + STEPS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=0, atol=ATOL)
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    for i in range(STEPS):
        ref_tok = jnp.argmax(ref_logits[:, -1:], -1).astype(jnp.int32)
        assert np.array_equal(tok.numpy(), np.asarray(ref_tok)), i
        ref_logits, ref_caches = ref_decode_step(
            ref_params, ref_cfg, ref_tok, ref_caches, jnp.int32(PROMPT + i))
        logits, caches = decode_step(params, cfg, tok, caches, PROMPT + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=0, atol=ATOL, err_msg=f"step {i}")
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_train_step_matches_reference_value_and_grad(weights, option):
    ref_cfg, ref_params, cfg, params = _models(weights, option)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, 13)).astype(np.int32)

    def ref_loss(p, t):
        return ref_cross_entropy(ref_forward(p, ref_cfg, t[:, :-1]),
                                 t[:, 1:])
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref_loss))(
        ref_params, jnp.asarray(toks))
    loss, grads = _value_and_grad(
        lambda p, b: cross_entropy(forward(p, cfg, b["tokens"]),
                                   b["labels"]), params,
        {"tokens": torch.from_numpy(toks[:, :-1].copy()),
         "labels": torch.from_numpy(toks[:, 1:].copy())})
    assert abs(float(loss) - float(want_loss)) \
        <= LOSS_RTOL * abs(float(want_loss))
    got, want = tree_leaves(grads), jax.tree.leaves(want_grads)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float64)
        err = float(np.abs(g.numpy() - w).max() / max(np.abs(w).max(),
                                                      1e-30))
        assert err <= GRAD_TOL, (option, i, tuple(g.shape), err)


def test_merge_with_a_cap_prefills_uncapped_and_decodes_capped(weights):
    """The reference's merged path applies no cap (its
    ``_head_merged_attention``) while decode caps (``_gqa_scores``): with
    both options the prefill logits are the uncapped model's, and a decode
    step from the same cache is the capped model's."""
    _, _, both, params = _models(weights, "merge+softcap")
    capped = dataclasses.replace(both, attn_head_merge=False)
    plain = dataclasses.replace(both, attn_head_merge=False,
                                attn_logit_softcap=0.0)
    prompt = torch.from_numpy(_tokens(both, PROMPT, 3))
    got, caches = prefill(params, both, prompt, max_len=PROMPT + 1)
    want, _ = prefill(params, plain, prompt, max_len=PROMPT + 1)
    other, _ = prefill(params, capped, prompt, max_len=PROMPT + 1)
    assert float((got - want).abs().max()) < 1e-6
    assert float((got - other).abs().max()) > 100 * ATOL
    tok = torch.argmax(got[:, -1:], -1).to(torch.int32)
    copy = [type(c)(*(t.clone() for t in c)) for c in caches]
    copy2 = [type(c)(*(t.clone() for t in c)) for c in caches]
    step, _ = decode_step(params, both, tok, caches, PROMPT)
    step_capped, _ = decode_step(params, capped, tok, copy, PROMPT)
    step_plain, _ = decode_step(params, plain, tok, copy2, PROMPT)
    assert torch.equal(step, step_capped)
    assert float((step - step_plain).abs().max()) > 100 * ATOL


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_kernel_entries_take_the_cap(dtype, backward):
    """Each of the four C entries takes the cap as a float before the
    stream, in the order of the wrapper's ctypes parameter list; the
    wrapper refuses a negative or infinite cap."""
    import ctypes
    import importlib
    import re
    from pathlib import Path

    from repro_torch.kernels._build import SOURCES
    # the package exports the wrapper under the module's name
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    routes = fa._BWD_ROUTES if backward else fa._ROUTES
    lib, entry, _ = routes[getattr(torch, dtype)]
    src = (Path(fa.__file__).resolve().parent.parent / "csrc"
           / SOURCES[lib][0]).read_text()
    params = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)",
                       src).group(1)
    kinds = [p.strip().rsplit(" ", 1)[0].replace("const ", "")
             for p in params.split(",")]
    names = [p.strip().rsplit(" ", 1)[1] for p in params.split(",")]
    want = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}
    assert [want[k] for k in kinds] == fa._argtypes(getattr(torch, dtype),
                                                    backward)
    assert names[-2:] == ["softcap", "stream"]
    q = torch.zeros(1, 2, 8, 64, dtype=getattr(torch, dtype))
    for bad in (-1.0, float("inf")):
        with pytest.raises(ValueError, match="softcap"):
            fa._check_args(q, q, q, 0, bad)
