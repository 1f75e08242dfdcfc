"""Time variants of the bf16 flash backward against the kernels as they are
(the card is needed).

    python3 tools/flash_bwd_variants.py [--variants loading_warp,stages3]

Each variant is ``csrc/flash_attention_bwd_sm90.cu`` with a few lines
changed (``VARIANTS``), built with the port's nvcc flags into
``build/repro_torch/variants/``; its ``-Xptxas -v`` registers and spills
are printed per kernel and head dim.  Every variant runs on the same inputs
at h2o-danube-1.8b's training shape (B=4, H=32, KV=8, S=8192, D=80, window
4096) and at B=4, H=KV=16, S=4096, D=128, causal; its gradients must be
bit for bit the current kernels' (the variants change where work runs, not
the arithmetic), and it is timed in turns with the others (current,
variants, variants in reverse, current), in TFLOP/s on the unmasked pairs'
five products and as a share of their bound.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = (((4, 32, 8, 8192, 80), 4096), ((4, 16, 16, 4096, 128), 0))
_DEC = '    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n" ::: "memory");\n'
_INC = '  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n" ::: "memory");\n'
#: name → (what it changes, [(old text, new text), ...])
VARIANTS = {
    "loading_warp": (
        "a loading warp instead of a warpgroup: 288 threads, no setmaxnreg",
        [("constexpr int kThreads = 384;", "constexpr int kThreads = 288;"),
         (_DEC, ""), (_DEC, ""), (_INC, ""), (_INC, "")]),
    "stages3": ("three stages in both rings instead of two",
                [("constexpr int kStages = 2;",
                  "constexpr int kStages = 3;")]),
}


def variant_source(base: str, edits) -> str:
    for old, new in edits:
        if old not in base:
            raise ValueError(f"variant edit not found in the source: {old!r}")
        base = base.replace(old, new, 1)
    return base


def build(name: str, src: str):
    """→ the variant's entry point; prints its ptxas report."""
    from repro_torch.kernels import _build
    out_dir = _build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}.cu"
    cu.write_text(src)
    lib = out_dir / f"lib{name}.so"
    res = subprocess.run([_build._nvcc(),
                          *_build._flags("flash_attention_bwd_sm90"),
                          "-I", str(_build._CSRC), "-o", str(lib), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                           f"{res.stderr}")
    kernel = None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '.*?(flash_bwd_\w+?_sm90)"
                      r"ILi(\d+)ELb([01])E", line)
        if m:
            kernel = (f"{m.group(1)} D={m.group(2)}"
                      f"{' softcap' if m.group(3) == '1' else ''}")
        elif kernel and ("registers" in line or "spill" in line):
            print(f"[build] {name} {kernel}: {line.strip()}")
    fn = ctypes.CDLL(str(lib)).flash_attention_bwd_bf16_sm90
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p]
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import H100_BF16_FLOPS, card_line, cuda_ms
    from repro_torch.kernels.flash_attention import (flash_attention_forward,
                                                     flash_pairs)
    base = (ROOT / "src" / "repro_torch" / "csrc" /
            "flash_attention_bwd_sm90.cu").read_text()
    names = ["current"] + [n for n in args.variants.split(",") if n]
    fns = {name: build(name, base if name == "current"
                       else variant_source(base, VARIANTS[name][1]))
           for name in names}
    for name in names[1:]:
        print(f"[variant] {name}: {VARIANTS[name][0]}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    same_all = True
    for (b, h, kv, s, d), window in SHAPES:
        q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, kv, s, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, kv, s, d, generator=gen, device="cuda").bfloat16()
        dout = torch.randn(b, h, s, d, generator=gen,
                           device="cuda").bfloat16()
        out, lse = flash_attention_forward(q, k, v, window=window)

        def run(name):
            grads = tuple(torch.empty_like(t) for t in (q, k, v))
            dsum = torch.empty_like(lse)
            err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), dout.data_ptr(),
                            *(g.data_ptr() for g in grads), lse.data_ptr(),
                            dsum.data_ptr(), b, h, kv, s, d,
                            1.0 / math.sqrt(d), 1, window, 0.0,
                            torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return grads

        want = run("current")
        for name in names[1:]:
            same = all(torch.equal(a, w) for a, w in zip(run(name), want))
            same_all &= same
            print(f"[bits] {(b, h, kv, s, d)} window={window} {name}: bit "
                  f"for bit the current kernels' {same}")
        del want
        pairs, _ = flash_pairs(s, True, window)
        ops = 10 * b * h * d * pairs
        bound = ops / H100_BF16_FLOPS * 1e3
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(cuda_ms(torch, lambda: run(name), 5, 1)[0])
        for name, t in times.items():
            print(f"[time] {(b, h, kv, s, d)} window={window} {name}: "
                  f"{t[0]:.3f} / {t[1]:.3f} ms, {ops / min(t) / 1e9:.1f} "
                  f"TFLOP/s on the 5 products, {100 * bound / min(t):.1f} % "
                  f"of the {bound:.6f}-ms bound")
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    print(f"[card] {card_line()}")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
