"""Hold the bf16 flash forward's output bit for bit against an earlier
version of its source (the card is needed).

    git show <commit>:src/repro_torch/csrc/flash_attention_sm90.cu > build/old_fwd.cu
    python3 tools/flash_fwd_bitwise.py --old build/old_fwd.cu

builds the old source with the port's nvcc flags into ``build/repro_torch/``
and runs it and the current kernel (``flash_attention_forward``) on the same
inputs: h2o-danube-1.8b's prefill and training shapes, phi3-mini's and
olmoe-1b-7b's prefill, and small ragged cases.  It fails unless every
output is bitwise equal.  An old source whose entry takes no log-sum-exp
pointer (before the backward read it) is called without one.
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

# (B, H, KV, S, D), causal, window
SHAPES = (((4, 32, 8, 4608, 80), True, 4096),
          ((4, 32, 8, 8192, 80), True, 4096),
          ((4, 32, 32, 4064, 96), True, 0),
          ((4, 16, 16, 4064, 128), True, 0),
          ((1, 8, 2, 333, 80), True, 100),
          ((1, 4, 1, 1000, 64), False, 0),
          ((1, 4, 2, 300, 96), False, 64))


def build_old(path: Path):
    from repro_torch.kernels import _build
    src = path.read_bytes()
    flags = _build._flags("flash_attention_sm90")
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out = _build.build_dir() / f"libflash_attention_sm90_old-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *flags, "-o", str(out), str(path)],
                       check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).flash_attention_bf16_sm90
    takes_lse = b"void* lse" in src.split(b'extern "C" int '
                                          b'flash_attention_bf16_sm90(')[1] \
        .split(b")")[0]
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (4 + takes_lse) + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn, takes_lse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="an earlier csrc/flash_attention_sm90.cu")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_fwd_bitwise: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import flash_attention_forward
    old, takes_lse = build_old(args.old)
    gen = torch.Generator(device="cuda").manual_seed(26)
    same_all = True
    for (b, h, kv, s, d), causal, window in SHAPES:
        q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, kv, s, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, kv, s, d, generator=gen, device="cuda").bfloat16()
        new, _ = flash_attention_forward(q, k, v, causal=causal,
                                         window=window)
        want = torch.empty_like(q)
        scratch = torch.empty(b, h, s, device="cuda")
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), want.data_ptr()) \
            + ((scratch.data_ptr(),) if takes_lse else ())
        err = old(*ptrs, b, h, kv, s, d, 1.0 / math.sqrt(d), int(causal),
                  window, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        same = err == 0 and torch.equal(new.view(torch.int16),
                                        want.view(torch.int16))
        same_all &= same
        print(f"[flash_fwd_bitwise] {(b, h, kv, s, d)} causal={causal} "
              f"window={window}: bit for bit {same} (old launch error {err})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[flash_fwd_bitwise] card: {card}; every output bit for bit: "
          f"{same_all}")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
