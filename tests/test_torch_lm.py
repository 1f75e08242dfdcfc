"""Port parity, the LM serving path: the reference's ``init_params`` weights
carried across with ``lm_params_from_numpy``, then ``forward`` and
``prefill`` + greedy decode of the port against the JAX package on the
SMOKE configs of all ten reference archs (dense, sliding-window, QKV bias
and tied embeddings, Mamba-2, MoE, the jamba hybrid, command-r's parallel
block with layernorm, internvl2's vision prefix, musicgen's GELU), the
analytic parameter counts, and the serve entry point."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_archs as ref_all_archs  # noqa: E402
from repro.configs import get as ref_get  # noqa: E402
from repro.models import decode_step as ref_decode_step  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import prefill as ref_prefill  # noqa: E402

from repro_torch.checkpoint import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decode_step, forward, prefill  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ARCHS = ["command-r-plus-104b", "h2o-danube-1.8b", "internvl2-76b",
         "jamba-1.5-large-398b", "mamba2-130m", "mixtral-8x22b",
         "musicgen-medium", "olmoe-1b-7b", "phi3-mini-3.8b", "qwen1.5-0.5b"]
# the reference's decode-consistency tolerance (tests/test_models.py:21):
# float32 weights and activations, sums in another order across frameworks
ATOL = 2e-5
# prompt longer than danube-smoke's window of 8 (the ring buffer wraps in
# decode) and not a multiple of the SSD chunk (front padding)
BATCH, PROMPT, STEPS, CHUNK = 2, 13, 6, 4
# the reference's decode step, compiled once a config and reused by every
# greedy step (run eagerly, each step dispatches op by op: ~2 s a step on
# jamba's SMOKE config)
_ref_decode = jax.jit(ref_decode_step, static_argnums=(1,))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(arch, reference cfg, reference params, port cfg, port params)."""
    arch = request.param
    ref_cfg = ref_get(arch).smoke_config
    cfg = get(arch).smoke_config
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_params)
    return arch, ref_cfg, ref_params, cfg, lm_params_from_numpy(tree, cfg,
                                                                "cpu")


def _tokens(cfg, s, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (BATCH, s)).astype(np.int32)


def test_forward_matches_reference(models):
    arch, ref_cfg, ref_params, cfg, params = models
    toks = _tokens(cfg, PROMPT + STEPS)
    want = np.asarray(ref_forward(ref_params, ref_cfg, jnp.asarray(toks),
                                  ssd_chunk=CHUNK))
    got = forward(params, cfg, torch.from_numpy(toks), ssd_chunk=CHUNK)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_prefill_and_greedy_decode_match_reference(models):
    arch, ref_cfg, ref_params, cfg, params = models
    prompt = _tokens(cfg, PROMPT, seed=2)
    max_len = PROMPT + STEPS
    ref_logits, ref_caches = ref_prefill(ref_params, ref_cfg,
                                         jnp.asarray(prompt),
                                         ssd_chunk=CHUNK, max_len=max_len)
    logits, caches = prefill(params, cfg, torch.from_numpy(prompt),
                             ssd_chunk=CHUNK, max_len=max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=0, atol=ATOL)
    for ref_c, c in zip(ref_caches, caches):
        for name, ref_leaf, leaf in zip(c._fields, ref_c, c):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(ref_leaf),
                                       rtol=0, atol=ATOL, err_msg=name)
    ref_tok = jnp.argmax(ref_logits[:, -1:], -1).astype(jnp.int32)
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    for i in range(STEPS):
        assert np.array_equal(tok.numpy(), np.asarray(ref_tok)), (arch, i)
        ref_logits, ref_caches = _ref_decode(
            ref_params, ref_cfg, ref_tok, ref_caches, jnp.int32(PROMPT + i))
        logits, caches = decode_step(params, cfg, tok, caches, PROMPT + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=0, atol=ATOL, err_msg=f"step {i}")
        ref_tok = jnp.argmax(ref_logits[:, -1:], -1).astype(jnp.int32)
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)


def test_decode_matches_forward_over_the_generated_sequence(models):
    """The port against itself: prefill + decode logits equal the full
    forward over prompt + generated tokens (tests/test_models.py:21)."""
    arch, _, _, cfg, params = models
    toks = torch.from_numpy(_tokens(cfg, PROMPT + STEPS, seed=3))
    full = forward(params, cfg, toks, ssd_chunk=CHUNK)
    _, caches = prefill(params, cfg, toks[:, :PROMPT], ssd_chunk=CHUNK,
                        max_len=PROMPT + STEPS)
    for t in range(PROMPT, PROMPT + STEPS):
        lg, caches = decode_step(params, cfg, toks[:, t:t + 1], caches, t)
        err = float((lg[:, 0] - full[:, t]).abs().max())
        assert err < ATOL, (arch, t, err)


def test_converter_rejects_missing_extra_and_misshaped_leaves(models):
    arch, ref_cfg, ref_params, cfg, _ = models
    tree = jax.tree.map(np.asarray, ref_params)
    missing = dict(tree)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="missing leaves"):
        lm_params_from_numpy(missing, cfg, "cpu")
    extra = dict(tree, bias=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra leaves"):
        lm_params_from_numpy(extra, cfg, "cpu")
    blocks = [dict(b) for b in tree["blocks"]]
    blocks[0]["norm1"] = {"scale": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="does not fit"):
        lm_params_from_numpy(dict(tree, blocks=blocks), cfg, "cpu")


def test_converter_carries_bf16_bits_exactly():
    """A bf16 leaf (ml_dtypes) crosses as its 16-bit patterns."""
    cfg = dataclasses.replace(get("mamba2-130m").smoke_config,
                              dtype="bfloat16")
    ref_cfg = dataclasses.replace(ref_get("mamba2-130m").smoke_config,
                                  dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        ref_init_params(ref_cfg, jax.random.PRNGKey(0)))
    params = lm_params_from_numpy(tree, cfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert np.array_equal(params["embed"].view(torch.int16).numpy(),
                          tree["embed"].view(np.int16))


def test_vision_embeds_replace_the_prefix_as_the_references_do():
    """internvl2's stub frontend: patch embeddings (a numpy seed) replace
    the first ``vision_tokens`` positions in ``forward`` and ``prefill``."""
    arch = "internvl2-76b"
    ref_cfg, cfg = ref_get(arch).smoke_config, get(arch).smoke_config
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                                  "cpu")
    toks = _tokens(cfg, PROMPT, seed=4)
    rng = np.random.default_rng(6)
    ve = rng.standard_normal((BATCH, cfg.vision_tokens, cfg.d_model)) \
        .astype(np.float32)
    want = np.asarray(ref_forward(ref_params, ref_cfg, jnp.asarray(toks),
                                  vision_embeds=jnp.asarray(ve)))
    got = forward(params, cfg, torch.from_numpy(toks),
                  vision_embeds=torch.from_numpy(ve))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    plain = forward(params, cfg, torch.from_numpy(toks))
    assert float((got - plain).abs().max()) > 1e-3     # the prefix mattered
    ref_logits, ref_caches = ref_prefill(
        ref_params, ref_cfg, jnp.asarray(toks),
        vision_embeds=jnp.asarray(ve), max_len=PROMPT + STEPS)
    logits, caches = prefill(params, cfg, torch.from_numpy(toks),
                             vision_embeds=torch.from_numpy(ve),
                             max_len=PROMPT + STEPS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=0, atol=ATOL)
    for ref_c, c in zip(ref_caches, caches):
        for name, ref_leaf, leaf in zip(c._fields, ref_c, c):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(ref_leaf),
                                       rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_the_reference(arch):
    """``num_params`` / ``active_params`` of the full and SMOKE configs."""
    for cfg, ref_cfg in ((get(arch).config, ref_get(arch).config),
                         (get(arch).smoke_config,
                          ref_get(arch).smoke_config)):
        assert cfg.num_params() == ref_cfg.num_params()
        assert cfg.active_params() == ref_cfg.active_params()
    cfg = get(arch).config
    assert (cfg.active_params() < cfg.num_params()) == (cfg.moe_experts > 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch, monkeypatch):
    """Every arch serves; a layernorm arch (command-r, musicgen) makes no
    ``rmsnorm`` call."""
    calls = []

    def counted(*args):
        calls.append(1)
        return rmsnorm(*args)
    rmsnorm = layers.rmsnorm
    monkeypatch.setattr(layers, "rmsnorm", counted)
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt", "11", "--steps", "4"])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    cfg = get(arch).smoke_config
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < \
        cfg.vocab_size
    assert res.prefill_ms > 0 and res.decode_tok_s > 0
    assert bool(calls) == (cfg.norm == "rmsnorm"), (arch, len(calls))


def test_unported_options_and_archs_raise():
    """Every reference arch is registered, and an unknown one is a
    ``KeyError``; every option of ``ModelConfig`` runs (none is refused any
    more: their parity is in tests/test_torch_quantize.py and
    tests/test_torch_attn_options.py)."""
    from repro_torch.models import init_params
    assert all_archs() == ref_all_archs() == tuple(ARCHS)
    cfg = get("h2o-danube-1.8b").smoke_config
    params = init_params(cfg, device="cpu")
    with pytest.raises(KeyError, match="registered"):
        get("no-such-arch")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    for change in (dict(attn_logit_softcap=30.0), dict(quantize_weights=True),
                   dict(attn_head_merge=True)):
        opt = dataclasses.replace(cfg, **change)
        init_params(opt, device="cpu")
        assert forward(params, opt, toks).shape == (1, 4, cfg.vocab_size)
