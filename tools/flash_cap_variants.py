"""Time variants of the capped bf16 flash kernels' tanh (the card is needed).

    python3 tools/flash_cap_variants.py [--only NAME,...]

Builds copies of ``src/repro_torch/csrc/flash_attention_sm90.cu`` and
``flash_attention_bwd_sm90.cu`` whose capped (``kCap``) instantiations take
t = tanh(s·cap_in) by another pattern of forms (``VARIANTS``), with the
port's nvcc flags, into ``build/repro_torch/cap_variants/``, and times each
capped kernel at h2o-danube-1.8b's prefill (4, 32, 8, 4608, 80) and training
(4, 32, 8, 8192, 80) shapes, window 4096, cap 50 (Gemma 2's, on q and k
scaled ×8 so that it bites), in turns (the variants, then in reverse),
beside the uncapped kernel.  A pattern gives the form of the score at place
j of a thread's unrolled tile by j mod its length:

  R  the rational form (``csrc/softcap_sm90.cuh``'s ``tanh_rational``)
  E  the exp form (``tanh_exp``)
  P  two exp-form scores sharing one reciprocal (forward only)
  A  ``tanh.approx.f32``: a speed reference, not accurate enough to ship
  L  no tanh (t = s·cap_in): the capped kernel's floor

The committed kernels are ``EREE`` for both, with warpgroup turns in the
backward only.  It prints each variant's error against the plain version
(forward) or against the committed kernels (backward).  Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CAP = 50.0
QK_SCALE = 8.0
FWD_SHAPE = (4, 32, 8, 4608, 80)
BWD_SHAPE = (4, 32, 8, 8192, 80)
WINDOW = 4096

# name: (forward pattern, backward pattern, turns in the backward)
VARIANTS = {
    "committed": ("EREE", "EREE", True),
    "rational": ("R", "R", True),
    "exp": ("E", "E", True),
    "exp_no_turns": ("E", "E", False),
    "one_in_two": ("ER", "ER", True),
    "one_in_eight": ("EREEEEEE", "EREEEEEE", True),
    "pairs": ("PP", "E", True),
    "pairs_rational": ("PPRPPPPR", "EREE", True),
    "approx": ("A", "A", True),
    "no_tanh": ("L", "L", True),
}

EXTRA = """
__device__ __forceinline__ float tanh_approx(float s, float cap_in) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(s * cap_in));
  return t;
}

__device__ __forceinline__ void tanh_exp_pair(float& a, float& b, float k2) {
  float ea, eb, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(ea) : "f"(fminf(a * k2, 64.f)));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(eb) : "f"(fminf(b * k2, 64.f)));
  const float ha = fmaf(ea, -0.5f, -0.5f), hb = fmaf(eb, -0.5f, -0.5f);
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(ha * hb));
  a = fmaf(r, hb, 1.f);
  b = fmaf(r, ha, 1.f);
}
"""
NO_TURNS = """
#define turn_wait(wg) ((void)0)
#define turn_pass(wg) ((void)0)
#define turn_init(wg) ((void)0)
"""
FWD_LOOP = ("    for (int j = 0; j < kBK / 2; ++j) s[j] = "
            "softcap_tanh(j, s[j], k);")
BWD_CALLS = ("t = softcap_tanh(j, x, k);",)


def _form(c: str, x: str) -> str:
    return {"R": f"tanh_rational({x}, k.k_in)", "E": f"tanh_exp({x}, k.k2)",
            "A": f"tanh_approx({x}, cap_in)", "L": f"({x} * cap_in)"}[c]


def forward_source(src: str, pattern: str) -> str:
    """The forward with its capped loop unrolled by ``pattern``."""
    lines, g = [], len(pattern)
    for g0 in range(0, 64, g):
        pairs = []
        for j in range(g0, min(g0 + g, 64)):
            c = pattern[j - g0]
            if c == "P":
                pairs.append(j)
            else:
                lines.append(f"    s[{j}] = {_form(c, f's[{j}]')};")
        if len(pairs) % 2:
            raise ValueError(f"pattern {pattern!r}: an unpaired P")
        lines += [f"    tanh_exp_pair(s[{a}], s[{b}], k.k2);"
                  for a, b in zip(pairs[::2], pairs[1::2])]
    if FWD_LOOP not in src:
        raise ValueError("the forward's capped loop is not in the source")
    return src.replace(FWD_LOOP, "\n".join(lines))


def backward_source(src: str, pattern: str, turns: bool) -> str:
    """The backward with each score's form chosen by ``pattern``."""
    if "P" in pattern:
        raise ValueError("the backward takes no paired form")
    cases = " : ".join(f"j % {len(pattern)} == {i} ? {_form(c, 'x')}"
                       for i, c in enumerate(pattern[:-1]))
    expr = (f"{cases} : {_form(pattern[-1], 'x')}" if cases
            else _form(pattern[-1], "x"))
    for call in BWD_CALLS:
        if call not in src:
            raise ValueError("the backward's capped call is not in the "
                             "source")
        src = src.replace(call, f"t = {expr};")
    if not turns:
        src = src.replace('#include "softcap_sm90.cuh"',
                          '#include "softcap_sm90.cuh"\n' + NO_TURNS)
    return src


def build(names):
    """→ {(variant, source name): CDLL}, built in parallel."""
    from repro_torch.kernels import _build
    header = (_build._CSRC / "softcap_sm90.cuh").read_text() + EXTRA
    srcs = {n: (_build._CSRC / f"{n}.cu").read_text()
            for n in ("flash_attention_sm90", "flash_attention_bwd_sm90")}
    procs = {}
    for v in names:
        fwd, bwd, turns = VARIANTS[v]
        d = _build.build_dir() / "cap_variants" / v
        d.mkdir(parents=True, exist_ok=True)
        (d / "softcap_sm90.cuh").write_text(header)
        made = {"flash_attention_sm90":
                forward_source(srcs["flash_attention_sm90"], fwd),
                "flash_attention_bwd_sm90":
                backward_source(srcs["flash_attention_bwd_sm90"], bwd,
                                turns)}
        for name, text in made.items():
            (d / f"{name}.cu").write_text(text)
            procs[(v, name)] = subprocess.Popen(
                [_build._nvcc(), *_build._flags(name), "-o",
                 str(d / f"lib{name}.so"), str(d / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (v, name), p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {v} {name}:\n{out[-3000:]}")
        libs[(v, name)] = ctypes.CDLL(
            str(_build.build_dir() / "cap_variants" / v / f"lib{name}.so"))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_attention_ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)
    if not torch.cuda.is_available():
        print("flash_cap_variants: needs a CUDA device", file=sys.stderr)
        return 1
    names = [n for n in args.only.split(",") if n] or list(VARIANTS)
    t0 = time.perf_counter()
    libs = build(names)
    print(f"[build] {len(names)} variants in {time.perf_counter() - t0:.1f}"
          f" s; card: {cs.card_line()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    def use(v):
        for name in ("flash_attention_sm90", "flash_attention_bwd_sm90"):
            _build._LIBS[name] = libs[(v, name)]
    order = names + names[::-1]

    B, H, KV, S, D = FWD_SHAPE
    G = H // KV
    q, k, v = (rnd(B, H, S, D, scale=QK_SCALE),
               rnd(B, KV, S, D, scale=QK_SCALE), rnd(B, KV, S, D))
    want = flash_attention_ref(q[:1, :G], k[:1, :1], v[:1, :1],
                               window=WINDOW, softcap=CAP).float()
    times = {n: [] for n in names}
    for n in order:
        use(n)
        times[n].append(cs.cuda_ms(torch, lambda: flash_attention_forward(
            q, k, v, window=WINDOW, softcap=CAP), 20)[0])
    unc = cs.cuda_ms(torch, lambda: flash_attention_forward(
        q, k, v, window=WINDOW), 20)[0]
    for n in names:
        use(n)
        got = flash_attention_forward(q, k, v, window=WINDOW,
                                      softcap=CAP)[0][:1, :G].float()
        t = times[n]
        print(f"[forward] {n} {VARIANTS[n][0]}: {t[0]:.4f} / {t[1]:.4f} ms, "
              f"uncapped {unc:.4f} ms, {min(t) / unc:.3f}x; rel err vs "
              f"plain {cs.rel_err(torch, got, want):.3e}", flush=True)
    del q, k, v, want

    B, H, KV, S, D = BWD_SHAPE
    q, k, v = (rnd(B, H, S, D, scale=QK_SCALE),
               rnd(B, KV, S, D, scale=QK_SCALE), rnd(B, KV, S, D))
    dout = rnd(B, H, S, D)
    use(names[0])
    out, lse = flash_attention_forward(q, k, v, window=WINDOW, softcap=CAP)
    ref = flash_attention_backward(q, k, v, out, dout, lse, window=WINDOW,
                                   softcap=CAP)
    times = {n: [] for n in names}
    for n in order:
        use(n)
        times[n].append(cs.cuda_ms(torch, lambda: flash_attention_backward(
            q, k, v, out, dout, lse, window=WINDOW, softcap=CAP), 3, 1)[0])
    o0, l0 = flash_attention_forward(q, k, v, window=WINDOW)
    unc = cs.cuda_ms(torch, lambda: flash_attention_backward(
        q, k, v, o0, dout, l0, window=WINDOW), 3, 1)[0]
    for n in names:
        use(n)
        got = flash_attention_backward(q, k, v, out, dout, lse,
                                       window=WINDOW, softcap=CAP)
        errs = [cs.rel_err(torch, a.float(), b.float())
                for a, b in zip(got, ref)]
        t = times[n]
        print(f"[backward] {n} {VARIANTS[n][1]} turns {VARIANTS[n][2]}: "
              f"{t[0]:.3f} / {t[1]:.3f} ms, uncapped {unc:.3f} ms, "
              f"{min(t) / unc:.3f}x; rel err vs {names[0]} "
              f"{max(errs):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
