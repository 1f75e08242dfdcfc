"""Hold the uncapped f32 flash kernels bit for bit against an earlier version
of their sources (the card is needed).

    python3 tools/flash_f32_bitwise.py
    python3 tools/flash_f32_bitwise.py --old <dir>

builds the old sources (by default ``tools/flash_tf32_double_cap/``: the
split-tf32 forward and backward and their ``sm90_common.cuh`` as they were
while the cap ran in double) with the port's nvcc flags into
``build/repro_torch/`` and runs them and the current kernels
(``flash_attention_forward`` and ``flash_attention_backward``, float32,
uncapped) on the same inputs: h2o-danube-1.8b's f32 prefill and training
shapes, phi3-mini's and olmoe-1b-7b's prefill at batch 1, and small ragged
cases.  It fails unless the forward's output and row log-sum-exp and the
backward's dq, dk and dv are all bitwise equal.  Then it runs the capped
instantiations (``softcap=CAP``) at the same shapes on inputs scaled so
that the cap bites: each launch must take the capped kernels and give
finite values that differ from the uncapped ones.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OLD = ROOT / "tools" / "flash_tf32_double_cap"
LIBS = {"flash_attention_tf32_sm90": ("flash_attention_tf32_sm90.cu",
                                      "flash_attention_f32_tf32_sm90"),
        "flash_attention_bwd_tf32_sm90": (
            "flash_attention_bwd_tf32_sm90.cu",
            "flash_attention_bwd_f32_tf32_sm90")}
# Gemma 2's published attn_logit_softcapping, and the scale of q and k that
# makes it bite
CAP = 50.0
QK_SCALE = 8.0

# (B, H, KV, S, D), causal, window: danube's f32 prefill and training
# shapes at batch 1, phi3-mini's and olmoe's prefill, small ragged cases
SHAPES = (((1, 32, 8, 4608, 80), True, 4096),
          ((1, 32, 8, 8192, 80), True, 4096),
          ((1, 32, 32, 4064, 96), True, 0),
          ((1, 16, 16, 4064, 128), True, 0),
          ((1, 8, 2, 333, 80), True, 100),
          ((1, 4, 1, 1000, 64), False, 0),
          ((1, 4, 2, 300, 96), False, 64))


def build_old(old: Path = OLD) -> dict:
    """Build the old forward and backward → {library: (entry, scratch
    entry)} as ctypes functions."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import _argtypes
    import torch
    header = (old / "sm90_common.cuh").read_bytes()
    out = {}
    procs = []
    for lib, (src_name, entry) in LIBS.items():
        src = (old / src_name).read_bytes()
        flags = _build._flags(lib)
        digest = hashlib.sha256(src + header + " ".join(flags).encode()) \
            .hexdigest()[:16]
        path = _build.build_dir() / f"lib{lib}_old-{digest}.so"
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            procs.append(subprocess.Popen(
                [_build._nvcc(), *flags, "-I", str(old), "-o", str(path),
                 str(old / src_name)], stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE))
        out[lib] = (path, entry)
    for proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on an old source:\n"
                               f"{err.decode(errors='replace')}")
    fns = {}
    for lib, (path, entry) in out.items():
        so = ctypes.CDLL(str(path))
        fn = getattr(so, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = _argtypes(torch.float32, "bwd" in lib)
        scratch = getattr(so, entry + "_scratch")
        scratch.restype = ctypes.c_longlong
        scratch.argtypes = [ctypes.c_int] * 5
        fns[lib] = (fn, scratch)
    return fns


def _old_forward(torch, fns, q, k, v, causal, window):
    fn, scratch_of = fns["flash_attention_tf32_sm90"]
    b, h, s, d = q.shape
    kv = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, device="cuda")
    scratch = torch.empty(scratch_of(b, h, kv, s, d), device="cuda")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), scratch.data_ptr(), b, h, kv, s, d,
             1.0 / math.sqrt(d), int(causal), window, 0.0,
             torch.cuda.current_stream().cuda_stream)
    return err, out, lse


def _old_backward(torch, fns, q, k, v, out, dout, lse, causal, window):
    fn, scratch_of = fns["flash_attention_bwd_tf32_sm90"]
    b, h, s, d = q.shape
    kv = k.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty(b, h, s, device="cuda")
    scratch = torch.empty(scratch_of(b, h, kv, s, d), device="cuda")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             lse.data_ptr(), dsum.data_ptr(), scratch.data_ptr(), b, h, kv,
             s, d, 1.0 / math.sqrt(d), int(causal), window, 0.0,
             torch.cuda.current_stream().cuda_stream)
    return err, (dq, dk, dv)


def _bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=OLD,
                    help="a directory holding earlier flash_attention_tf32_"
                    "sm90.cu, flash_attention_bwd_tf32_sm90.cu and "
                    "sm90_common.cuh (default: %(default)s)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_f32_bitwise: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_forward)
    fns = build_old(args.old)
    gen = torch.Generator(device="cuda").manual_seed(32)
    same_all = True
    for (b, h, kv, s, d), causal, window in SHAPES:
        q = torch.randn(b, h, s, d, generator=gen, device="cuda")
        k = torch.randn(b, kv, s, d, generator=gen, device="cuda")
        v = torch.randn(b, kv, s, d, generator=gen, device="cuda")
        dout = torch.randn(b, h, s, d, generator=gen, device="cuda")
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           window=window)
        grads = flash_attention_backward(q, k, v, out, dout, lse,
                                         causal=causal, window=window)
        e_f, out0, lse0 = _old_forward(torch, fns, q, k, v, causal, window)
        e_b, grads0 = _old_backward(torch, fns, q, k, v, out0, dout, lse0,
                                    causal, window)
        torch.cuda.synchronize()
        fwd = e_f == 0 and _bits(out, out0) and _bits(lse, lse0)
        bwd = e_b == 0 and all(_bits(x, y) for x, y in zip(grads, grads0))
        same_all &= fwd and bwd
        # the capped instantiations on q, k scaled so that the cap bites
        qc, kc = (t * QK_SCALE for t in (q, k))
        before = (flash_attention.capped_launches,
                  flash_attention_backward.capped_launches)
        c_out, c_lse = flash_attention_forward(qc, kc, v, causal=causal,
                                               window=window, softcap=CAP)
        c_grads = flash_attention_backward(qc, kc, v, c_out, dout, c_lse,
                                           causal=causal, window=window,
                                           softcap=CAP)
        u_out, u_lse = flash_attention_forward(qc, kc, v, causal=causal,
                                               window=window)
        u_grads = flash_attention_backward(qc, kc, v, u_out, dout, u_lse,
                                           causal=causal, window=window)
        torch.cuda.synchronize()
        capped = (c_out, *c_grads)
        ran = ((flash_attention.capped_launches,
                flash_attention_backward.capped_launches)
               == (before[0] + 1, before[1] + 1)
               and all(bool(torch.isfinite(x).all()) for x in capped)
               and not any(torch.equal(x, y) for x, y in
                           zip(capped, (u_out, *u_grads))))
        same_all &= ran
        print(f"[flash_f32_bitwise] {(b, h, kv, s, d)} causal={causal} "
              f"window={window}: forward (output, lse) bit for bit {fwd}, "
              f"backward (dq, dk, dv) bit for bit {bwd} (old launch errors "
              f"{e_f}, {e_b}); softcap {CAP:g} forward and backward ran, "
              f"finite and unlike the uncapped ones: {ran} (max |capped - "
              f"uncapped| output "
              f"{float((c_out - u_out).abs().max()):.3f}, dq "
              f"{float((c_grads[0] - u_grads[0]).abs().max()):.3f})")
        del q, k, v, dout, out, lse, grads, out0, lse0, grads0
        del qc, kc, c_out, c_lse, c_grads, u_out, u_lse, u_grads, capped
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[flash_f32_bitwise] card: {card}; every uncapped output bit for "
          f"bit and every capped launch run: {same_all}")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
