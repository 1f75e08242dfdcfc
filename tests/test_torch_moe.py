"""Port parity, the capacity-routed MoE layer: the port's ``moe_ffn`` against
the reference's on one repeat's slice of the reference's own weights — with
tokens dropped at capacity, with a group size that does not divide into the
configured one, at decode's size and with tied router scores — its routing
against the reference's rule replayed in numpy, a per-token top-k loop at
ample capacity, and the MoE leaves through ``lm_params_from_numpy``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as ref_get  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models.layers import moe_ffn as ref_moe_ffn  # noqa: E402

from repro_torch.checkpoint import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.layers import moe_ffn, moe_route  # noqa: E402

# float32 weights and activations; sums in another order across frameworks
ATOL = 2e-5


def _layer(arch, seed=0, **change):
    """(reference cfg, port cfg, {leaf: numpy}) of the first MoE position's
    FFN, repeat 0, from the reference's ``init_params``."""
    ref_cfg = dataclasses.replace(ref_get(arch).smoke_config, **change)
    cfg = dataclasses.replace(get(arch).smoke_config, **change)
    tree = jax.tree.map(np.asarray,
                        ref_init_params(ref_cfg, jax.random.PRNGKey(seed)))
    pos = [f for _, f in cfg.block_pattern].index("moe")
    return ref_cfg, cfg, {k: v[0] for k, v in
                          tree["blocks"][pos]["ffn"].items()}


def _x(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _reference_kept(ref_cfg, router, x):
    """The reference's capacity rule replayed on its own top-k: (n, k) bool,
    whether each (token, choice) found a slot, and the capacity."""
    n = x.shape[0] * x.shape[1]
    e, k = ref_cfg.moe_experts, ref_cfg.moe_top_k
    sg = min(ref_cfg.moe_group_size, n)
    while n % sg:
        sg -= 1
    cap = min(int(np.ceil(sg * k * ref_cfg.capacity_factor / e / 4.0) * 4),
              sg)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(n, -1)) @ router, axis=-1)
    ids = np.asarray(jax.lax.top_k(probs, k)[1])
    kept = np.zeros((n, k), bool)
    for g in range(n // sg):
        taken = np.zeros(e, int)
        for j in range(k):               # every token's choice j, then j+1
            for t in range(g * sg, (g + 1) * sg):
                kept[t, j] = taken[ids[t, j]] < cap
                taken[ids[t, j]] += 1
    return kept, cap


def _check(arch, b, s, **change):
    """moe_ffn of both packages on the same slice and inputs → the port's
    route."""
    ref_cfg, cfg, p = _layer(arch, **change)
    x = _x(cfg, b, s)
    want = np.asarray(ref_moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), ref_cfg))
    tp = {k: torch.tensor(v) for k, v in p.items()}
    got = moe_ffn(tp, torch.from_numpy(x), cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    route = moe_route(tp["router"], torch.from_numpy(x).reshape(b * s, -1),
                      cfg)
    kept, cap = _reference_kept(ref_cfg, p["router"], x)
    assert route.capacity == cap
    assert np.array_equal(route.kept().numpy(), kept)
    return route


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b"])
def test_moe_ffn_drops_tokens_as_the_reference(arch):
    """At capacity_factor 1.0 an expert takes sg·k/E tokens of a group:
    the assignments past it are dropped, the same ones in both packages."""
    route = _check(arch, 2, 16, capacity_factor=1.0)
    assert route.groups == 1 and route.group_size == 32
    assert int((~route.kept()).sum()) >= 1


def test_moe_ffn_group_size_not_dividing_the_tokens():
    """n = 2·19 with groups of 32: the reference lowers the group to 19."""
    route = _check("olmoe-1b-7b", 2, 19)
    assert (route.groups, route.group_size, route.capacity) == (2, 19, 19)
    assert bool(route.kept().all())


@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_moe_ffn_at_decode_size(cf):
    """One token a sequence (n = B), as each decode step routes them."""
    route = _check("olmoe-1b-7b", 4, 1, capacity_factor=cf)
    assert route.group_size == 4


def test_tied_router_scores_go_to_the_lower_expert():
    """A zero router ties every expert: both packages take experts 0..k-1
    in that order, so expert 0 fills first and the rest drop."""
    ref_cfg, cfg, p = _layer("olmoe-1b-7b", capacity_factor=1.0)
    p = dict(p, router=np.zeros_like(p["router"]))
    x = _x(cfg, 2, 16)
    want = np.asarray(ref_moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), ref_cfg))
    tp = {k: torch.tensor(v) for k, v in p.items()}
    np.testing.assert_allclose(moe_ffn(tp, torch.from_numpy(x), cfg).numpy(),
                               want, rtol=0, atol=ATOL)
    route = moe_route(tp["router"], torch.from_numpy(x).reshape(32, -1), cfg)
    experts = route.slot // (route.groups * route.capacity)
    kept = route.kept()
    assert torch.equal(experts[kept[:, 0], 0],
                       torch.zeros(route.capacity, dtype=torch.int64))
    assert int(kept.sum()) == 2 * route.capacity
    assert torch.equal(route.gates, torch.full((32, 2), 0.5))


def test_moe_matches_a_per_token_top_k_loop():
    """At ample capacity (cap = sg) the routed layer is each token's top-k
    experts weighted by its renormalised gates (the reference's
    tests/test_models.py test, on the port's own weights), in float64."""
    cfg = dataclasses.replace(get("olmoe-1b-7b").smoke_config,
                              capacity_factor=4.0)
    p = {k: v[0] for k, v in
         init_params(cfg, seed=3, device="cpu")["blocks"][0]["ffn"].items()}
    x = torch.from_numpy(_x(cfg, 2, 8, seed=2))
    y = moe_ffn(p, x, cfg).double().numpy()
    router, wg, wu, wd = (p[k].double().numpy()
                          for k in ("router", "w_gate", "w_up", "w_down"))
    xn = x.double().numpy().reshape(16, -1)
    logits = xn @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = np.zeros_like(xn)
    for t in range(16):
        top = np.argsort(-probs[t], kind="stable")[:cfg.moe_top_k]
        gates = probs[t, top] / probs[t, top].sum()
        for gate, e in zip(gates, top):
            a = xn[t] @ wg[e]
            want[t] += gate * ((a / (1 + np.exp(-a)) * (xn[t] @ wu[e]))
                               @ wd[e])
    np.testing.assert_allclose(y.reshape(16, -1), want, rtol=0, atol=1e-5)


def test_converter_carries_the_moe_leaves():
    """The router stays float32 and the experts keep their (reps, E, d, f)
    layout and bf16 bits."""
    arch = "olmoe-1b-7b"
    ref_cfg = dataclasses.replace(ref_get(arch).smoke_config,
                                  dtype="bfloat16")
    cfg = dataclasses.replace(get(arch).smoke_config, dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        ref_init_params(ref_cfg, jax.random.PRNGKey(0)))
    ffn = lm_params_from_numpy(tree, cfg, "cpu")["blocks"][0]["ffn"]
    ref_ffn = tree["blocks"][0]["ffn"]
    reps, e, d, f = 2, cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    assert ffn["router"].dtype == torch.float32
    assert tuple(ffn["router"].shape) == (reps, d, e)
    assert np.array_equal(ffn["router"].numpy(), ref_ffn["router"])
    for name, shape in (("w_gate", (reps, e, d, f)), ("w_up", (reps, e, d, f)),
                        ("w_down", (reps, e, f, d))):
        assert ffn[name].dtype == torch.bfloat16
        assert tuple(ffn[name].shape) == shape
        assert np.array_equal(ffn[name].view(torch.int16).numpy(),
                              ref_ffn[name].view(np.int16))
