"""Time the capped f32 flash forward with and without warpgroup turns (the
card is needed).

    python3 tools/flash_f32_cap_turns.py

builds three copies of ``csrc/flash_attention_tf32_sm90.cu`` that differ
only in which capped instantiations take turns to start S (``kTurns``): as
committed (64-key tiles: D = 64, 80, 96), none, and all head dims; then
times each copy's capped (softcap 50, q and k scaled ×8) and uncapped
forward at batch 1 of danube's prefill (D = 80, window 4096) and at D = 96
and 128 causal, the copies in turns (each copy once forward, once backward
in the order), and checks that every copy gives the same capped output
(turns move no arithmetic).
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
LINE = "  constexpr bool kTurns = kCap && kBK == 64;\n"
VARIANTS = {"committed": LINE,
            "none": "  constexpr bool kTurns = false;\n",
            "all": "  constexpr bool kTurns = kCap;\n"}
# (B, H, KV, S, D), window (causal throughout)
SHAPES = (((1, 32, 8, 4608, 80), 4096), ((1, 32, 32, 4064, 96), 0),
          ((1, 16, 16, 4064, 128), 0))
CAP, QK_SCALE = 50.0, 8.0


def build() -> dict:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import _argtypes
    text = (_build._CSRC / "flash_attention_tf32_sm90.cu").read_text()
    if LINE not in text:
        raise RuntimeError("the source's kTurns line moved")
    out = _build.build_dir() / "cap_turns"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, line in VARIANTS.items():
        src = out / f"{name}.cu"
        src.write_text(text.replace(LINE, line))
        lib = out / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build._flags("flash_attention_tf32_sm90"),
             "-I", str(_build._CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        so = ctypes.CDLL(str(lib))
        fn = so.flash_attention_f32_tf32_sm90
        fn.restype, fn.argtypes = ctypes.c_int, _argtypes(torch.float32)
        scratch = so.flash_attention_f32_tf32_sm90_scratch
        scratch.restype = ctypes.c_longlong
        scratch.argtypes = [ctypes.c_int] * 5
        fns[name] = (fn, scratch)
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_f32_cap_turns: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    fns = build()
    print(f"[cap_turns] card: {chip_smoke.card_line()}")
    gen = torch.Generator(device="cuda").manual_seed(27)
    ok = True
    for (b, h, kv, s, d), window in SHAPES:
        q = torch.randn(b, h, s, d, generator=gen, device="cuda") * QK_SCALE
        k = torch.randn(b, kv, s, d, generator=gen, device="cuda") * QK_SCALE
        v = torch.randn(b, kv, s, d, generator=gen, device="cuda")
        outs = {}

        def call(name, cap):
            fn, scratch_of = fns[name]
            out = torch.empty_like(q)
            lse = torch.empty(b, h, s, device="cuda")
            scratch = torch.empty(scratch_of(b, h, kv, s, d), device="cuda")
            outs[name, cap] = out

            def run():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                         b, h, kv, s, d, 1.0 / math.sqrt(d), 1, window, cap,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")
            return run
        runs = {(n, c): call(n, c) for n in fns for c in (CAP, 0.0)}
        ms = {key: [] for key in runs}
        for key in list(runs) + list(reversed(list(runs))):
            ms[key].append(chip_smoke.cuda_ms(torch, runs[key], 20)[0])
        torch.cuda.synchronize()
        same = all(torch.equal(outs[n, CAP], outs["committed", CAP])
                   for n in fns)
        ok &= same
        print(f"[cap_turns] {(b, h, kv, s, d)} window {window}: " + "; ".join(
            f"{n}: capped {min(ms[n, CAP]):.4f} ms ("
            + ", ".join(f"{x:.4f}" for x in ms[n, CAP])
            + f"), uncapped {min(ms[n, 0.0]):.4f}, "
            f"{min(ms[n, CAP]) / min(ms[n, 0.0]):.3f}x" for n in fns)
            + f"; capped outputs equal: {same}")
        del q, k, v, outs
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
