"""Port parity, the f32 flash kernels' arithmetic: a plain mirror of
``csrc/flash_attention_tf32_sm90.cu`` and ``csrc/flash_attention_bwd_tf32_
sm90.cu`` (tf32 rounding as ``cvt.rna`` by bit operations on int32 views,
the three-product split, each kernel's tile order from its Python tile plan,
its exp2 and rescale, the saved log-sum-exp, and under the logit softcap
the cap's f32 form against each row's anchor) against the reference's
Pallas kernel in interpret mode and ``jax.grad`` of its plain attention,
at every head dim the kernels are built for, with GQA, a window edge inside
a tile, a ragged S, ``causal=False`` and the logit softcap; a one-product
tf32 mirror on the same inputs must miss the tolerance, so that the
tolerance tells the two apart.  Then the kernels' tile plans against the
dense mask and the sources' tile constants, and the build's hash of the
headers a source includes.

Tolerance: 1e-5 normwise (max |got − want| / max |want|), the f32 kernels'
tolerance on the card (``chip_smoke.py`` ``LM_TOL``).  The mirror's sums run
in another order than the card's tensor cores, so it shows the split's
error, not the card's bits.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, TF32_DKV_TILES, TF32_DQ_TILES, TF32_FWD_TILES,
    flash_bwd_tile_plan, flash_mask, flash_tile_plan)
from test_torch_softcap_f32_formula import (  # noqa: E402
    cap_delta, cap_exponent, cap_for, cap_row)

TOL = 1e-5
CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
NEG = -1e30
LOG2E = 1.4426950408889634


# ------------------------------------------------------------- the split
def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: to the nearest float with 10 mantissa bits,
    ties away from zero, by adding half of the dropped 13 bits to the
    magnitude and clearing them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, terms: int = 3):
    """a @ b as the kernels take it: three tf32 products of the split
    (a_lo·b_hi + a_hi·b_lo + a_hi·b_hi), or one (a_hi·b_hi) with
    ``terms=1``."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if terms == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _visible(rows, keys, s, causal, window):
    i = torch.as_tensor(rows)[:, None]
    t = torch.as_tensor(keys)[None, :]
    ok = (i < s) & (t < s)
    if causal:
        ok &= t <= i
        if window > 0:
            ok &= t > i - window
    return ok


def _capped(st, cap, anchor):
    """A tile's base-2 exponents against each row's anchor (its largest raw
    score, broadcast along the keys) and C·(1 − tanh²), in float32 by the
    kernels' form (``cap_row``, ``cap_exponent`` in ``csrc/sm90_common.cuh``;
    ``tests/test_torch_softcap_f32_formula.py``)."""
    return cap_exponent(st, cap, cap_row(anchor, cap))


# ------------------------------------------------------------ the mirrors
def mirror_forward(q, k, v, *, causal, window, softcap=0.0, terms=3):
    """The forward kernel: 128-query tiles against the key tiles its plan
    visits (``TF32_FWD_TILES``), the online softmax in exp2 on raw scores
    (c = log2(e)/sqrt(D); a row max still -1e30 counts as 0; under a cap
    each exponent against the running max of the raw scores, the anchor,
    and alpha the old anchor's against the new), each tile's P·V (P split
    in registers) added to O rescaled by alpha → (out, lse in base 2; under
    a cap each row's anchor, its largest raw score)."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    kx, vx = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    bq, bk = TF32_FWD_TILES[d]
    scale = 1.0 / math.sqrt(d)
    c = scale * LOG2E
    cap = cap_for(d, softcap) if softcap else None
    out = torch.zeros_like(q)
    lse = torch.zeros(b, h, s)
    for n, tile in enumerate(flash_tile_plan(s, bq, bk, causal, window)):
        q0 = n * bq
        rows = range(q0, min(q0 + bq, s))
        qt = q[:, :, q0:q0 + bq]
        m = torch.full((b, h, len(rows)), NEG)
        l = torch.zeros(b, h, len(rows))
        o = torch.zeros(b, h, len(rows), d)
        for kt in range(tile.lo, tile.hi + 1):
            keys = range(kt * bk, (kt + 1) * bk)
            kk = kx[:, :, kt * bk:(kt + 1) * bk]
            st = product(qt, kk.transpose(-1, -2), terms)
            if st.shape[-1] < bk:       # keys past S read as zeros
                st = torch.nn.functional.pad(st, (0, bk - st.shape[-1]))
            if kt in tile.masked:
                st = torch.where(_visible(rows, keys, s, causal, window), st,
                                 torch.tensor(NEG))
            mx = torch.maximum(m, st.amax(-1))
            if softcap:
                new = cap_row(mx, cap)
                alpha = torch.exp2(cap_delta(cap_row(m, cap)["x"]
                                             - new["x"], new)[0])
                p = torch.exp2(_capped(st, cap, mx[..., None])[0])
                p = torch.where(st == NEG, 0.0, p)
            else:
                mc = torch.where(mx == NEG, 0.0, mx * c)
                alpha = torch.exp2(m * c - mc)
                p = torch.exp2(st * c - mc[..., None])
            l = l * alpha + p.sum(-1)
            m = mx
            vv = vx[:, :, kt * bk:(kt + 1) * bk]
            p = p[..., :vv.shape[2]]
            o = o * alpha[..., None] + product(p, vv, terms)
        out[:, :, q0:q0 + bq] = o / torch.where(l == 0, 1.0, l)[..., None]
        lse[:, :, q0:q0 + bq] = m if softcap else torch.where(
            l == 0, math.inf, m * c + torch.log2(l))
    return out, lse


def mirror_backward(q, k, v, dout, lse, *, causal, window, softcap=0.0,
                    terms=3):
    """The two backward kernels on the forward's saved lse: the dq kernel
    (64-query tiles against its plan's key tiles, ``TF32_DQ_TILES``; a
    first pass sums each row's l = Σ_t p and D_i = Σ_t p·dP / l, the second
    dQ with p / l) and the dk/dv kernel (64-key tiles, each group head's
    query tiles of its plan, ``TF32_DKV_TILES``, summed in that order, on
    those l and D_i; under a cap ``lse`` holds the rows' anchors, p is
    exp2 of each exponent against its row's, and dS takes C·(1 − tanh²),
    dq and dk a final ·scale / C) → (dq, dk, dv)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    c = scale * LOG2E
    cap = cap_for(d, softcap) if softcap else None
    # dS carries C·(1 − tanh²) under a cap
    out_scale = float(torch.tensor(scale) * cap["inv_c"]) if softcap \
        else scale
    di = torch.zeros(b, h, s)
    rowsum = torch.zeros(b, h, s)

    def p_ds(st, dpt, lse_rows, di_rows, ok, inv_rows=1.0):
        """p and dS of one tile (rows × columns); lse, D_i and 1 / l
        broadcast."""
        g = None
        if softcap:      # the exponent against the row's anchor
            x, g = _capped(st, cap, lse_rows)
            p = torch.exp2(x)
        else:
            p = torch.exp2(st * c - lse_rows)
        p = torch.where(ok, p, 0.0) * inv_rows
        ds = p * (dpt - di_rows)
        if softcap:
            ds = ds * g
        return p, ds

    # dq kernel: pass 1 sums D_i, pass 2 dQ
    kx, vx = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    bq, bk = TF32_DQ_TILES[d]
    dq = torch.zeros_like(q)
    for n, tile in enumerate(flash_tile_plan(s, bq, bk, causal, window)):
        q0 = n * bq
        rows = range(q0, min(q0 + bq, s))
        acc = torch.zeros(b, h, len(rows), d)
        for second in (False, True):
            for kt in range(tile.lo, tile.hi + 1):
                keys = range(kt * bk, min((kt + 1) * bk, s))
                kk = kx[:, :, keys.start:keys.stop]
                st = product(q[:, :, q0:q0 + bq], kk.transpose(-1, -2),
                             terms)
                dpt = product(dout[:, :, q0:q0 + bq],
                              vx[:, :, keys.start:keys.stop]
                              .transpose(-1, -2), terms)
                p, ds = p_ds(st, dpt, lse[:, :, q0:q0 + bq, None],
                             di[:, :, q0:q0 + bq, None],
                             _visible(rows, keys, s, causal, window),
                             rowsum[:, :, q0:q0 + bq, None] if second
                             else 1.0)
                if second:
                    acc = acc + product(ds, kk, terms)
                else:
                    rowsum[:, :, q0:q0 + bq] += p.sum(-1)
                    di[:, :, q0:q0 + bq] += (p * dpt).sum(-1)
            if not second:       # → 1 / l and D_i = Σ p·dP / l
                rowsum[:, :, q0:q0 + bq] = 1 / rowsum[:, :, q0:q0 + bq]
                di[:, :, q0:q0 + bq] *= rowsum[:, :, q0:q0 + bq]
        dq[:, :, q0:q0 + bq] = acc * out_scale

    # dk/dv kernel
    bq, bk = TF32_DKV_TILES[d]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for n, tile in enumerate(flash_bwd_tile_plan(s, bq, bk, causal,
                                                 window)):
        k0 = n * bk
        keys = range(k0, min(k0 + bk, s))
        acc_k = torch.zeros(b, kvh, len(keys), d)
        acc_v = torch.zeros(b, kvh, len(keys), d)
        kk, vv = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        for j in range(g):
            heads = [x * g + j for x in range(kvh)]   # head j of each group
            for qt in range(tile.lo, tile.hi + 1):
                rows = range(qt * bq, min((qt + 1) * bq, s))
                qq = q[:, heads, rows.start:rows.stop]
                do = dout[:, heads, rows.start:rows.stop]
                st = product(kk, qq.transpose(-1, -2), terms)
                dpt = product(vv, do.transpose(-1, -2), terms)
                p, ds = p_ds(st, dpt,
                             lse[:, heads, None, rows.start:rows.stop],
                             di[:, heads, None, rows.start:rows.stop],
                             _visible(rows, keys, s, causal, window).T,
                             rowsum[:, heads, None, rows.start:rows.stop])
                acc_v = acc_v + product(p, do, terms)
                acc_k = acc_k + product(ds, qq, terms)
        dk[:, :, k0:k0 + bk] = acc_k * out_scale
        dv[:, :, k0:k0 + bk] = acc_v
    return dq, dk, dv


# --------------------------------------------------------- the references
def _ref_forward(qn, kn, vn, causal, window, softcap):
    """The reference: its Pallas kernel in interpret mode; with a cap, its
    model's capped scores (``_gqa_scores``) and ``_attend``."""
    if not softcap:
        return np.asarray(pallas_flash(jnp.asarray(qn), jnp.asarray(kn),
                                       jnp.asarray(vn), causal=causal,
                                       window=window, interpret=True))
    return np.asarray(_ref_capped(jnp.asarray(qn), jnp.asarray(kn),
                                  jnp.asarray(vn), causal, window, softcap))


def _ref_capped(q, k, v, causal, window, softcap):
    s, d = q.shape[2], q.shape[3]
    scores = ref_layers._gqa_scores(q.transpose(0, 2, 1, 3),
                                    k.transpose(0, 2, 1, 3),
                                    1.0 / math.sqrt(d), softcap)
    mask = np.ones((s, s), bool) if not causal else \
        np.asarray(flash_mask(s, causal, window))
    ctx = ref_layers._attend(scores, v.transpose(0, 2, 1, 3),
                             jnp.asarray(mask))
    return ctx.transpose(0, 2, 1, 3)


def _ref_grads(qn, kn, vn, dn, causal, window, softcap):
    """jax.grad of ⟨the reference's attention, dout⟩ (ref.py's plain
    attention; with a cap, the model's capped attention)."""
    def f(q, k, v):
        if softcap:
            out = _ref_capped(q, k, v, causal, window, softcap)
        else:
            out = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window)
        return jnp.sum(out * jnp.asarray(dn))
    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# (B, H, KV, S, D), causal, window, softcap: every head dim, GQA and MHA, a
# window edge inside a key tile, ragged S, causal=False (no window: the
# Pallas kernel skips key blocks by the window even then, where ref.py and
# the port apply none), the cap on scores that reach it
CASES = [((1, 4, 2, 200, 64), True, 0, 0.0),
         ((1, 4, 1, 300, 80), True, 100, 0.0),
         ((1, 2, 2, 200, 96), False, 0, 0.0),
         ((1, 4, 2, 270, 128), True, 77, 0.0),
         ((1, 4, 2, 190, 80), True, 0, 50.0)]
IDS = ["d64-gqa", "d80-window-in-tile", "d96-noncausal-ragged",
       "d128-window", "d80-softcap"]


@pytest.fixture(scope="module", params=list(range(len(CASES))), ids=IDS)
def case(request):
    """One case's inputs (numpy, a seed), the mirror's forward and the
    reference's output and gradients, computed once for the module."""
    shape, causal, window, softcap = CASES[request.param]
    b, h, kv, s, d = shape
    rng = np.random.default_rng(30 + request.param)
    # with a cap, q and k scaled so that scores reach it (tanh is linear
    # to 1e-4 below a tenth of the cap)
    amp = 8.0 if softcap else 1.0
    qn = (amp * rng.standard_normal((b, h, s, d))).astype(np.float32)
    kn = (amp * rng.standard_normal((b, kv, s, d))).astype(np.float32)
    vn = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    dn = rng.standard_normal((b, h, s, d)).astype(np.float32)
    want = _ref_forward(qn, kn, vn, causal, window, softcap)
    grads = _ref_grads(qn, kn, vn, dn, causal, window, softcap)
    t = [torch.from_numpy(x) for x in (qn, kn, vn, dn)]
    out, lse = mirror_forward(*t[:3], causal=causal, window=window,
                              softcap=softcap)
    return dict(t=t, np=(qn, kn, vn, dn), causal=causal, window=window,
                softcap=softcap, want=want, grads=grads, out=out, lse=lse)


def test_tf32_mirror_forward_matches_pallas(case):
    assert _rel(case["out"], case["want"]) <= TOL


def test_tf32_mirror_lse_is_the_rows_logsumexp(case):
    """The saved log-sum-exp (base 2) against the f64 log-sum-exp of the
    masked scores: a row's sum carries the split's error.  Under a cap the
    saved statistic is the row's anchor, its largest raw score: within the
    split's error of the f64 largest masked raw score, and the f64
    log-sum-exp of the capped scores lies between its capped score and that
    plus log(keys)."""
    qn, kn, _, _ = case["np"]
    d = qn.shape[-1]
    g = qn.shape[1] // kn.shape[1]
    raw = np.einsum("bhsd,bhtd->bhst", qn.astype(np.float64),
                    np.repeat(kn, g, 1).astype(np.float64))
    sc = raw / math.sqrt(d)
    if case["softcap"]:
        sc = case["softcap"] * np.tanh(sc / case["softcap"])
    mask = flash_mask(qn.shape[2], case["causal"], case["window"])
    if mask is not None:
        sc = np.where(mask.numpy(), sc, -np.inf)
        raw = np.where(mask.numpy(), raw, -np.inf)
    want = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) \
        + sc.max(-1)
    got = case["lse"].double().numpy()
    if not case["softcap"]:
        got = got * math.log(2)
        assert np.abs(got - want).max() <= 1e-5 * max(1.0,
                                                       np.abs(want).max())
        return
    top = raw.max(-1)
    assert np.abs(got - top).max() <= 1e-5 * np.abs(top).max()
    capped = case["softcap"] * np.tanh(got / math.sqrt(d) / case["softcap"])
    keys = np.isfinite(raw).sum(-1)
    assert (want >= capped - 1e-5).all()
    assert (want <= capped + np.log(keys) + 1e-5).all()


def test_tf32_mirror_gradients_match_jax_grad(case):
    q, k, v, dout = case["t"]
    grads = mirror_backward(q, k, v, dout, case["lse"],
                            causal=case["causal"], window=case["window"],
                            softcap=case["softcap"])
    for got, want in zip(grads, case["grads"]):
        assert _rel(got, want) <= TOL


def test_one_tf32_product_misses_the_tolerance(case):
    """The negative control: the same kernels with one tf32 product
    (a_hi·b_hi) land past 1e-5 on the same inputs, forward and backward."""
    q, k, v, dout = case["t"]
    out, lse = mirror_forward(q, k, v, causal=case["causal"],
                              window=case["window"],
                              softcap=case["softcap"], terms=1)
    assert _rel(out, case["want"]) > TOL
    grads = mirror_backward(q, k, v, dout, lse, causal=case["causal"],
                            window=case["window"], softcap=case["softcap"],
                            terms=1)
    assert max(_rel(g, w) for g, w in zip(grads, case["grads"])) > TOL


@pytest.mark.parametrize("x", [1.0, -1.0, 1.0 + 2.0 ** -11,
                               -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12,
                               3.14159265, -2.0 ** -30, 65504.0])
def test_tf32_rounds_to_nearest_ties_away(x):
    """``tf32`` keeps 10 mantissa bits: the nearest such value, a tie
    (exactly half of the last kept bit) away from zero, as ``cvt.rna``."""
    t = torch.tensor([x], dtype=torch.float32)
    got = float(tf32(t))
    m, e = math.frexp(float(t))          # |m| in [0.5, 1): 11 bits kept
    q = abs(m) * 2 ** 11
    want = math.copysign(math.floor(q + 0.5) * 2.0 ** (e - 11), m)
    assert got == want
    hi, lo = split(t)
    assert float(hi) + float(lo) == pytest.approx(float(t), rel=2 ** -21)


# ------------------------------------------------------------- tile plans
_PLANS = [(256, True, 0), (300, True, 100), (1000, True, 256),
          (200, False, 0), (333, True, 64), (130, True, 1), (4608, True, 4096)]


def _dense(s, causal, window):
    mask = flash_mask(s, causal, window)
    return torch.ones(s, s, dtype=torch.bool) if mask is None else mask


def _check_query_plan(s, bq, bk, causal, window):
    """``flash_tile_plan`` (the forward's and the dq kernel's loops): every
    key tile with an unmasked pair is visited, no visited tile is wholly
    masked, and an unmasked tile has no masked pair and no key past S."""
    mask = _dense(s, causal, window)
    plan = flash_tile_plan(s, bq, bk, causal, window)
    assert len(plan) == -(-s // bq)
    for n, tile in enumerate(plan):
        rows = mask[n * bq:(n + 1) * bq]
        for kt in range(-(-s // bk)):
            block = rows[:, kt * bk:(kt + 1) * bk]
            visited = tile.lo <= kt <= tile.hi
            assert visited == bool(block.any()), (n, kt)
            if visited and kt not in tile.masked:
                assert (kt + 1) * bk <= s and bool(block.all()), (n, kt)


def _check_key_plan(s, bq, bk, causal, window):
    """``flash_bwd_tile_plan`` (the dk/dv kernel's loop): every query that
    sees a key of the tile is in a visited query tile, and a visited tile
    is left unmasked exactly when it is full and wholly unmasked (query
    rows past S are masked there too)."""
    mask = _dense(s, causal, window)
    plan = flash_bwd_tile_plan(s, bq, bk, causal, window)
    assert len(plan) == -(-s // bk)
    for kt, tile in enumerate(plan):
        keys = slice(kt * bk, (kt + 1) * bk)
        rows = mask[:, keys].any(dim=1).nonzero().flatten()
        if rows.numel():
            assert tile.lo <= int(rows.min()) // bq
            assert int(rows.max()) // bq <= tile.hi
        for qt in range(tile.lo, tile.hi + 1):
            block = mask[qt * bq:(qt + 1) * bq, keys]
            full = block.shape == (bq, bk) and bool(block.all())
            assert (qt not in tile.masked) == full, (kt, qt)


@pytest.mark.parametrize("d", sorted(TF32_FWD_TILES))
@pytest.mark.parametrize("s,causal,window", _PLANS)
def test_tf32_plans_cover_the_mask(d, s, causal, window):
    """Every f32 kernel's plan at its tiles for head dim d: the forward's
    and the dq kernel's by query tile, the dk/dv kernel's by key tile."""
    _check_query_plan(s, *TF32_FWD_TILES[d], causal, window)
    _check_query_plan(s, *TF32_DQ_TILES[d], causal, window)
    _check_key_plan(s, *TF32_DKV_TILES[d], causal, window)


def test_tf32_tiles_are_the_sources():
    """The Python tiles are the sources' FWD_TILES / DQ_TILES / DKV_TILES
    (and their fixed 128 query rows, 64 query rows and 64 keys a block)."""
    fwd = (CSRC / "flash_attention_tf32_sm90.cu").read_text()
    bwd = (CSRC / "flash_attention_bwd_tf32_sm90.cu").read_text()
    assert "constexpr int kBQ = 128;" in fwd
    assert "constexpr int kDqBQ = 64;" in bwd
    assert "constexpr int kDkvBK = 64;" in bwd
    got = {int(d): (128, int(bk)) for d, bk, _ in
           re.findall(r"^FWD_TILES\((\d+), (\d+), (\d+)\)", fwd, re.M)}
    assert got == TF32_FWD_TILES
    got = {int(d): (64, int(bk)) for d, bk in
           re.findall(r"^DQ_TILES\((\d+), (\d+)\)", bwd, re.M)}
    assert got == TF32_DQ_TILES
    got = {int(d): (int(bq), 64) for d, bq in
           re.findall(r"^DKV_TILES\((\d+), (\d+)\)", bwd, re.M)}
    assert got == TF32_DKV_TILES
    assert sorted(TF32_FWD_TILES) == list(HEAD_DIMS)


# ------------------------------------------------------------------ build
def test_an_edited_header_changes_the_library_name(tmp_path, monkeypatch):
    """``_lib_path`` hashes the ``.cuh`` headers a source includes, so an
    edited header rebuilds every library that includes it (and only
    those); no nvcc is needed to name a library."""
    for f in CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    names = {n: _build._lib_path(n) for n in _build.SOURCES}
    header = tmp_path / "sm90_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    changed = {n for n in names if names[n] != after[n]}
    assert changed == {n for n, (src, _) in _build.SOURCES.items()
                       if '#include "sm90_common.cuh"'
                       in (tmp_path / src).read_text()}
    assert changed == {"flash_attention_tf32_sm90",
                       "flash_attention_bwd_tf32_sm90"}
