"""Fit the rational tanh of the bf16 flash kernels' logit softcap
(``src/repro_torch/csrc/softcap_sm90.cuh``) and print its constants.

    python3 tools/softcap_tanh_fit.py [--clamp 7.0]

The kernels clamp x = s·scale/softcap to [-C, C] and take z = x / (2C) in
[-1/2, 1/2] from one saturating FMA; then tanh(x) ≈ z·P(z²) / Q(z²), with P
of degree 3 in z², Q of degree 3 with Q(0) = 1 and one reciprocal.  The fit
is the minimax of the absolute error on z in [0, 1/2] (the function is odd)
with the clamp's tail, 1 − t(1/2), held to the same bound: differential
correction, a linear program a step (scipy), on a dense grid.  It prints
the largest error of the float32 evaluation over every 8th float32 x in
(0, 2C] and past the clamp, and the constant block of the header.
No card is needed; ``tests/test_torch_softcap_formula.py`` holds the
header's constants to the same bound.
"""
from __future__ import annotations

import argparse

import numpy as np


def fit(clamp: float, n: int = 6000, iters: int = 40):
    """→ (max abs error on the grid, P's 4 coefficients, Q's 3 above 1)."""
    from scipy.optimize import linprog
    z = np.unique(np.concatenate([np.linspace(0, .5, n),
                                  .5 * np.sin(np.linspace(0, np.pi / 2, n))]))
    f = np.tanh(2 * clamp * z)
    z, f = np.append(z, .5), np.append(f, 1.0)      # the tail past the clamp
    w = z * z
    pm = np.stack([z * w ** k for k in range(4)], 1)
    qm = np.stack([w ** k for k in range(1, 4)], 1)
    q, best = np.ones_like(z), None
    cost = np.zeros(8)
    cost[-1] = 1
    for _ in range(iters):
        # |f·Q − z·P| ≤ δ·Q_prev, minimise δ
        a = np.vstack([np.hstack([-pm, f[:, None] * qm, -q[:, None]]),
                       np.hstack([pm, -f[:, None] * qm, -q[:, None]])])
        res = linprog(cost, A_ub=a, b_ub=np.concatenate([-f, f]),
                      bounds=[(None, None)] * 7 + [(0, None)],
                      method="highs")
        p, qq = res.x[:4], res.x[4:7]
        qv = 1 + qm @ qq
        if np.any(qv <= 0):
            break
        err = float(np.max(np.abs(pm @ p / qv - f)))
        if best is not None and err >= best[0] * 0.9999:
            break
        best, q = (err, p, qq), qv
    return best


def tanh_f32(x, p, q, clamp: float):
    """The kernels' sequence in float32 on x = s·cap_in (float64 array):
    a fused multiply-add rounds once, the reciprocal is taken rounded."""
    f = np.float32
    k = f(f(1.0) / f(2 * clamp))
    y = np.clip((x.astype(np.float32).astype(np.float64) * np.float64(k)
                 + 0.5).astype(np.float32), 0, 1)
    z = (y - f(0.5)).astype(np.float32)
    w = (z.astype(np.float64) ** 2).astype(np.float32)

    def horner(c):
        acc = np.full_like(w, c[-1])
        for ck in c[-2::-1]:
            acc = (acc.astype(np.float64) * w + np.float64(ck)).astype(f)
        return acc
    num = (z.astype(np.float64) * horner(p)).astype(f)
    r = (1.0 / horner(np.concatenate([[f(1)], q])).astype(np.float64)
         ).astype(f)
    return (num.astype(np.float64) * r).astype(f)


def _c_float(v) -> str:
    s = f"{float(v):.9g}"
    return (s if "." in s or "e" in s else s + ".0") + "f"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clamp", type=float, default=7.0)
    args = ap.parse_args(argv)
    c = args.clamp
    err, p, q = fit(c)
    p32, q32 = p.astype(np.float32), q.astype(np.float32)
    top = np.float32(4 * c).view(np.int32)
    x = np.arange(1, top, 8, dtype=np.int32).view(np.float32).astype(
        np.float64)
    e32 = float(np.max(np.abs(tanh_f32(x, p32, q32, c) - np.tanh(x))))
    print(f"clamp {c:g}: minimax error {err:.3e} on the grid, float32 "
          f"evaluation {e32:.3e} over {x.size} float32 x in (0, {4 * c:g})")
    print(f"constexpr float kCapClamp = {c:.1f}f;")
    for name, v in (("kCapP", p32), ("kCapQ", q32)):
        vals = ", ".join(_c_float(t) for t in v)
        print(f"constexpr float {name}[{len(v)}] = {{{vals}}};")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
