"""The f32 flash kernels' capped exponent (``csrc/sm90_common.cuh``) on the CPU.

The capped (``kCap``) instantiations of ``flash_attention_tf32_sm90.cu`` and
``flash_attention_bwd_tf32_sm90.cu`` take each key's base-2 exponent against
its row's anchor, the row's largest raw score s_M at x_M = s_M·u (u =
1/(sqrt(D)·softcap), rounded to f32 and clamped): E = C·(tanh(x) − tanh(x_M)),
C = softcap·log2(e), by the difference form C·g_M·τ / (1 + t_M·τ), τ =
tanh(x − x_M), a polynomial near the anchor and one ex2 far from it, on the
f32 pipes only.  This test reads the form's constants and checks its steps
in the header, evaluates the same steps in float32 with torch (fused
multiply-adds rounded once; ex2.approx's and rcp.approx's results also moved
by 2 ulp each way, as ``tests/test_torch_softcap_formula.py`` takes them),
and holds, over float32 scores swept by bit pattern (every 509th, both
signs, from |x| = 1e-4 to saturation at |x| = 12) against anchors at the
cap, near 0 and at negative saturation:

* each key's exponent against float64 within the bound the header states,
  (1e-6 + 2^-22·|d|)·max(1, |E|) in base-2 units, d = x − x_M: 1e-6 for the
  keys that carry a row (|E| ≤ 1 within a unit of x of the anchor), relative
  to E beyond, where a key's probability is small;
* the backward's 1 − tanh² within (2e-6 + 2^-22·|d|) of itself;

at the caps and head dims the port runs.  A control: plain float32
r·(tanh − 1) (the capped score less the cap, r = softcap·sqrt(D), the
previous design's quantity) misses that bound at caps of 30 and 50.

The helpers (``cap_for``, ``cap_row``, ``cap_exponent``) are the form in
float32, which ``tests/test_torch_flash_tf32.py``'s kernel mirror uses.
"""
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "sm90_common.cuh")
F32 = torch.float32
LOG2E = 1.4426950408889634
ULP2 = 2.0 ** -22          # two float32 ulps of a result in [1, 2)
#: (softcap, head dim): Gemma 2's 50 at the port's four head dims, 30 and
#: the consistency check's cap of 1
CASES = [(50.0, 64), (50.0, 80), (50.0, 96), (50.0, 128), (30.0, 128),
         (1.0, 80)]
#: anchors x_M: at the cap, near 0, at negative saturation (and saturated
#: past them on both sides)
ANCHORS = (8.0, 2.5, 0.01, 0.0, -0.01, -2.5, -8.0)
#: (ex2, rcp) relative moves: none, and the four extremes
MOVES = ((0.0, 0.0), (ULP2, ULP2), (-ULP2, -ULP2), (ULP2, -ULP2),
         (-ULP2, ULP2))
#: the header's steps, so that an edit to the form shows here
STEPS = (
    "const float x = fminf(fmaxf(s * cap.u, -kCapClamp), kCapClamp);",
    "const float w_lo = fmaf(-ax, kCapK2Lo, fmaf(-ax, kCapK2, -w));",
    "const float e = fmaf(e0, w_lo * kCapLn2, e0);",
    "r = fmaf(r, fmaf(-den, r, 1.f), r);",
    "t = x < 0.f ? a - 1.f : 1.f - a;",
    "a1 = x < 0.f ? b : a;",
    "a2 = x < 0.f ? a : b;",
    "g = fmaf(-t, t, 1.f);",
    "const float inv = __frcp_rn(cap.c * g);",
    "return {x, t * inv, inv, a1 * inv, a2 * inv};",
    "const float e = exp2_approx(fminf(d * kCapK2, kCapExpMax));",
    "const bool near = fabsf(d) < kCapNear;",
    "const float v = near ? tau : e - 1.f;",
    "const float den = near ? fmaf(m.t, tau, m.one) : fmaf(m.a2, e, m.a1);",
    "const float q = near ? fmaf(-tau, tau, 1.f) : 4.f * e;",
    "cg = (r * r) * (q * m.one);",
    "return v * r;",
    "return cap_delta(fmaf(s, cap.u, -m.x), m, cg);",
    "const float q = fmaf(fmaf(kCapQ[2], z, kCapQ[1]), z, kCapQ[0]);",
    "return fmaf(d * z, q, d);",
)


def constants() -> dict:
    """The form's constants from the header."""
    text = HEADER.read_text()

    def floats(name):
        m = re.search(rf"constexpr float {name}(?:\[\d+\])?\s*=\s*"
                      rf"\{{?([^;}}]*)\}}?;", text)
        assert m, f"{name} not in {HEADER.name}"
        return [float(v.strip().rstrip("f")) for v in m.group(1).split(",")]
    out = {n: floats(n)[0] for n in ("kCapNear", "kCapClamp", "kCapExpMax",
                                     "kCapK2", "kCapK2Lo", "kCapLn2")}
    out["kCapQ"] = floats("kCapQ")
    return out


_K = constants()


def _f(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64).to(F32)


def fma(a, b, c) -> torch.Tensor:
    """fmaf: a·b + c rounded once (the product is exact in float64)."""
    a, b, c = (torch.as_tensor(t, dtype=F32) for t in (a, b, c))
    return (a.double() * b.double() + c.double()).to(F32)


def ex2(w: torch.Tensor, de: float = 0.0) -> torch.Tensor:
    """ex2.approx.ftz.f32, its result moved by (1 + de)."""
    y = (torch.exp2(w.double()) * (1 + de)).to(F32)
    return torch.where(y.abs() < 2.0 ** -126, 0.0, y)


def rcp(x: torch.Tensor, dr: float = 0.0) -> torch.Tensor:
    """rcp.approx.ftz.f32, its result moved by (1 + dr)."""
    return ((1 / x.double()) * (1 + dr)).to(F32)


def cap_for(head_dim: int, softcap: float) -> dict:
    """The kernels' ``Cap`` (``cap_for``): u, C and 1 / C in float32."""
    c = softcap * LOG2E
    return dict(u=_f(1.0 / (math.sqrt(head_dim) * softcap)), c=_f(c),
                inv_c=_f(1.0 / c))


def cap_tanh_near(d: torch.Tensor) -> torch.Tensor:
    z = d * d
    q = _K["kCapQ"]
    p = _f(q[-1])
    for c in reversed(q[:-1]):
        p = fma(p, z, _f(c))
    return fma(d * z, p, d)


def cap_row(s: torch.Tensor, cap: dict, de: float = 0.0,
            dr: float = 0.0) -> dict:
    """The header's ``cap_row``: an anchor's x_M, and t_M, 1 and 1 ∓ t_M
    over C·g_M (``__frcp_rn``: the reciprocal rounded once)."""
    s = torch.as_tensor(s, dtype=F32)
    clamp = _K["kCapClamp"]
    x = torch.clamp(s * cap["u"], -clamp, clamp)
    ax = x.abs()
    near = ax < _K["kCapNear"]
    tn = cap_tanh_near(torch.where(near, x, 0.0))
    k2 = _f(_K["kCapK2"])
    w = -ax * k2
    w_lo = fma(-ax, _f(_K["kCapK2Lo"]), fma(-ax, k2, -w))
    e0 = ex2(w, de)
    e = fma(e0, w_lo * _f(_K["kCapLn2"]), e0)
    den = 1 + e
    r = rcp(den, dr)
    r = fma(r, fma(-den, r, _f(1.0)), r)
    h = e * r
    a = h + h
    b = 2 - a
    neg = x < 0
    t = torch.where(near, tn, torch.where(neg, a - 1, 1 - a))
    g = torch.where(near, fma(-tn, tn, _f(1.0)), a * b)
    a1 = torch.where(near, 1 - tn, torch.where(neg, b, a))
    a2 = torch.where(near, 1 + tn, torch.where(neg, a, b))
    inv = (1 / (cap["c"] * g).double()).to(F32)
    return dict(x=x, t=t * inv, one=inv, a1=a1 * inv, a2=a2 * inv)


def cap_delta(d: torch.Tensor, m: dict, de: float = 0.0, dr: float = 0.0):
    """The header's ``cap_delta`` → (E, C·(1 − tanh²))."""
    near = d.abs() < _K["kCapNear"]
    tau = cap_tanh_near(torch.where(near, d, 0.0))
    e = ex2(torch.clamp(d * _f(_K["kCapK2"]), max=_K["kCapExpMax"]), de)
    v = torch.where(near, tau, e - 1)
    den = torch.where(near, fma(m["t"], tau, m["one"]),
                      fma(m["a2"], e, m["a1"]))
    q = torch.where(near, fma(-tau, tau, _f(1.0)), 4 * e)
    r = rcp(den, dr)
    return v * r, (r * r) * (q * m["one"])


def cap_exponent(s: torch.Tensor, cap: dict, m: dict, de: float = 0.0,
                 dr: float = 0.0):
    """The header's ``cap_exponent``: a raw score's exponent against anchor
    m → (E, C·(1 − tanh²))."""
    s = torch.as_tensor(s, dtype=F32)
    d = fma(s, cap["u"], -m["x"])
    return cap_delta(d, m, de, dr)


# ------------------------------------------------------------------ tests
def _scores(cap: dict) -> torch.Tensor:
    """0 and every 509th float32 bit pattern from |x| = 1e-4 to |x| = 12,
    with both signs."""
    u = float(cap["u"])
    lo, hi = (torch.tensor(x / u, dtype=F32).view(torch.int32).item()
              for x in (1e-4, 12.0))
    sweep = torch.arange(lo, hi, 509, dtype=torch.int32).view(F32)
    return torch.cat([torch.zeros(1), sweep, -sweep])


def _want(s: torch.Tensor, softcap: float, head_dim: int, x_m: torch.Tensor):
    """float64: E = C·(tanh(x) − tanh(x_M)) with the exact u and C, at the
    kernel's anchor x_M; d = x − x_M; 1 − tanh²(x) (from exp(−2|x|), which
    keeps a saturated key's bits)."""
    x = s.double() / (math.sqrt(head_dim) * softcap)
    xm = x_m.double()
    e = torch.exp(-2 * x.abs())
    g = 4 * e / (1 + e) ** 2
    return softcap * LOG2E * (torch.tanh(x) - torch.tanh(xm)), x - xm, g


def test_the_header_holds_the_form():
    """The constants and steps: the polynomial within 2^-25 of tanh
    (relative) below kCapNear, 2·log2(e) as a pair, ln 2, a clamp where the
    anchor is saturated far past float32's reach of 1 − tanh, and an ex2
    argument cap that keeps e finite."""
    text = HEADER.read_text()
    for step in STEPS:
        assert step in text, step
    d = torch.linspace(1e-6, _K["kCapNear"], 20001, dtype=torch.float64)
    z = d * d
    q = 0.0
    for c in reversed(_K["kCapQ"]):
        q = q * z + float(_f(c))
    poly = d + d * z * q
    assert float(((poly - torch.tanh(d)) / torch.tanh(d)).abs().max()) \
        < 2.0 ** -25
    k2 = float(_f(_K["kCapK2"]))           # as the compiler rounds it
    assert k2 == float(_f(2 * LOG2E))
    assert k2 + float(_f(_K["kCapK2Lo"])) == pytest.approx(2 * LOG2E,
                                                          rel=1e-15)
    assert float(_f(_K["kCapLn2"])) == float(_f(math.log(2)))
    assert 1 - math.tanh(_K["kCapClamp"]) < 1e-13
    assert 2.0 ** _K["kCapExpMax"] < 2.0 ** 127


@pytest.mark.parametrize("softcap,head_dim", CASES)
def test_a_keys_exponent_is_within_the_bound(softcap, head_dim):
    cap = cap_for(head_dim, softcap)
    s = _scores(cap)
    worst_e = worst_g = 0.0
    for xm in ANCHORS:
        s_m = _f(xm / float(cap["u"]))
        keys = s[s <= s_m]         # the anchor is its row's largest score
        for de, dr in MOVES:
            m = cap_row(s_m, cap, de, dr)
            got, cg = cap_exponent(keys, cap, m, de, dr)
            want, d, g = _want(keys, softcap, head_dim, m["x"])
            bound = (1e-6 + ULP2 * d.abs()) * want.abs().clamp(min=1.0)
            worst_e = max(worst_e, float(((got.double() - want).abs()
                                          / bound).max()))
            gb = (2e-6 + ULP2 * d.abs()) * g
            ok = g > 1e-30
            worst_g = max(worst_g, float(((cg.double() / (softcap * LOG2E)
                                           - g).abs() / gb)[ok].max()))
        assert bool(torch.isfinite(got).all() and torch.isfinite(cg).all())
    # the worst key of all anchors and moves, as a share of its bound
    assert worst_e <= 1.0, worst_e
    assert worst_g <= 1.0, worst_g


@pytest.mark.parametrize("softcap,head_dim",
                         [c for c in CASES if c[0] >= 30])
def test_plain_f32_misses_the_bound(softcap, head_dim):
    """The control: r·(tanh(x) − 1) in float32 (x = s·u, r = softcap·
    sqrt(D)), its exponent (y_j − y_M)·c with c = log2(e)/sqrt(D), misses
    the bound on the same keys against the anchor near 0, where every key
    rounds at ~r (at a cap of 1, C = 1.44, plain float32 is enough)."""
    cap = cap_for(head_dim, softcap)
    s = _scores(cap)
    u = cap["u"]
    r = _f(softcap * math.sqrt(head_dim))
    c = _f(LOG2E / math.sqrt(head_dim))
    s_m = _f(0.0)
    keys = s[s <= s_m]
    y = r * (torch.tanh(keys * u) - 1)
    y_m = r * (torch.tanh(s_m * u) - 1)
    got = y * c - y_m * c
    want, d, _ = _want(keys, softcap, head_dim, s_m * u)
    bound = (1e-6 + ULP2 * d.abs()) * want.abs().clamp(min=1.0)
    assert float(((got.double() - want).abs() / bound).max()) > 2.0


def test_a_masked_key_and_an_empty_row_stay_finite():
    """A masked score (-1e30) against a real anchor, and any score against
    the anchor of a row that saw none (-1e30): finite exponents (the kernels
    zero a masked key's probability after)."""
    cap = cap_for(80, 50.0)
    for s_m in (_f(-1e30), _f(300.0), _f(-300.0)):
        m = cap_row(s_m, cap)
        for s in (_f(-1e30), _f(0.0), _f(1e4)):
            e, cg = cap_exponent(s, cap, m)
            assert bool(torch.isfinite(e) and torch.isfinite(cg)), (s_m, s)
    # the anchor's own exponent is ~0, and alpha from an empty row is finite
    m = cap_row(_f(300.0), cap)
    assert abs(float(cap_exponent(_f(300.0), cap, m)[0])) < 1e-5
    e, _ = cap_delta(cap_row(_f(-1e30), cap)["x"] - m["x"], m)
    assert bool(torch.isfinite(e))
