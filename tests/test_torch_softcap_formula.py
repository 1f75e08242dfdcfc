"""The bf16 flash kernels' capped tanh (``csrc/softcap_sm90.cuh``) on the CPU.

The kernels (``flash_attention_sm90.cu``, ``flash_attention_bwd_sm90.cu``,
their ``kCap`` instantiations) take each raw score s to t = tanh(s·cap_in),
cap_in = scale / softcap, by one of two forms with the header's constants:
1 − 2/(1 + 2^(s·k2)) (ex2.approx, rcp.approx) or a clamped rational; the
capped score is softcap·t in scaled units.  This test reads those constants
from the header, evaluates both expressions in float32 with torch (the
exp form also with ex2's and rcp's results moved by their documented
error, 2 ulp each way), and holds softcap·t to the reference's
softcap·tanh(s·scale / softcap) in float64 (``src/repro/models/layers.py``'s
cap) within 1e-5·softcap for every score a bf16 input can give and for
float32 scores swept over their bit patterns (every 509th, both signs, past
the clamp), at the caps and head dims the port runs.  tanh.approx.f32,
whose relative error is near 2^-11, would miss that bound wherever
|tanh| > 0.02.
"""
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "softcap_sm90.cuh")
TOL = 1e-5
#: (softcap, head dim): Gemma 2's 50 at the port's four head dims, 30 and
#: the consistency check's cap of 1
CASES = [(50.0, 80), (50.0, 64), (50.0, 96), (50.0, 128), (30.0, 128),
         (1.0, 80)]


def _constants():
    text = HEADER.read_text()

    def floats(name):
        m = re.search(rf"constexpr float {name}(?:\[\d+\])?\s*=\s*"
                      rf"\{{?([^;}}]*)\}}?;", text)
        assert m, f"{name} not in {HEADER.name}"
        return [float(v.strip().rstrip("f")) for v in m.group(1).split(",")]
    assert "return {cap_in * (0.5f / kCapClamp), cap_in * kCapExp};" in text
    (clamp,) = floats("kCapClamp")
    (k_exp,) = floats("kCapExp")
    return clamp, floats("kCapP"), floats("kCapQ"), k_exp


def _f32(x: float):
    return torch.tensor(x, dtype=torch.float32)


def _rational(s, cap_in: float):
    """The header's ``tanh_rational(s, softcap_scales(cap_in).k_in)``."""
    clamp, p, q, _ = _constants()
    k_in = _f32(cap_in) * _f32(0.5 / clamp)
    z = torch.clamp(s * k_in + 0.5, 0.0, 1.0) - 0.5
    w = z * z
    num = ((p[3] * w + p[2]) * w + p[1]) * w + p[0]
    den = ((q[2] * w + q[1]) * w + q[0]) * w + 1.0
    return (z * num) * (1.0 / den)


def _exp(s, cap_in: float, de: float = 0.0, dr: float = 0.0):
    """The header's ``tanh_exp(s, softcap_scales(cap_in).k2)``, its ex2 and
    rcp results scaled by (1 + de) and (1 + dr)."""
    k2 = _f32(cap_in) * _f32(_constants()[3])
    e = torch.exp2(s * k2) * (1 + de)
    r = (1.0 / (e + 1.0)) * (1 + dr)
    return 1.0 - 2.0 * r


def _scores(cap_in: float):
    """Every finite bf16 value, and every 509th float32 bit pattern from 0 to
    four times the clamp, with both signs."""
    bf16 = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).float()
    clamp = _constants()[0]
    top = torch.tensor(4 * clamp / cap_in, dtype=torch.float32).view(
        torch.int32).item()
    sweep = torch.arange(0, top, 509, dtype=torch.int32).view(torch.float32)
    s = torch.cat([bf16, sweep, -sweep])
    return s[torch.isfinite(s)]


def test_the_header_holds_one_clamp_and_the_polynomials():
    clamp, p, q, k_exp = _constants()
    assert len(p) == 4 and len(q) == 3
    # near 0 the rational is x: z·p0 = x when p0 = 2·clamp
    assert math.isclose(p[0], 2 * clamp, rel_tol=1e-6)
    # tanh(clamp) is 1 within the bound, so the clamp's tail is inside it
    assert 1 - math.tanh(clamp) < TOL / 4
    assert math.isclose(k_exp, 2 / math.log(2), rel_tol=1e-7)


ULP2 = 2.0 ** -22          # two float32 ulps of a result in [1, 2)


@pytest.mark.parametrize("softcap,head_dim", CASES)
def test_a_capped_score_is_within_1e5_softcap_of_tanh(softcap, head_dim):
    scale = 1.0 / math.sqrt(head_dim)
    cap_in = float(_f32(scale / softcap))
    s = _scores(cap_in)
    want = softcap * torch.tanh(s.double() * (scale / softcap))
    forms = {"rational": _rational(s, cap_in)}
    # the two extremes of r = 1/(1 + e): e low and r high, e high and r low
    for de, dr in ((-ULP2, ULP2), (ULP2, -ULP2)):
        forms[f"exp {de:+.0e} {dr:+.0e}"] = _exp(s, cap_in, de, dr)
    for name, t in forms.items():
        err = (softcap * t.double() - want).abs()
        assert float(err.max()) <= TOL * softcap, (
            name, float(err.max()) / softcap, float(s[err.argmax()]))
    # the cap bites on these scores: past half the cap and at it
    assert float(want.abs().max()) > 0.999 * softcap
    # tanh.approx.f32's relative error, near 2^-11, would not hold
    assert float((want * 2.0 ** -11).abs().max()) > TOL * softcap
