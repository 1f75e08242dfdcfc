"""Compare the capped f32 flash kernels of two checkouts on the card.

    git archive <commit> | tar -x -C build/parent
    python3 tools/flash_f32_cap_compare.py build/parent .

runs, for each tree named (in the order given, then again in reverse, each
in a process of its own that builds that tree's kernels), the f32 cases of
that tree's ``chip_smoke.py`` ``softcap_checks`` (the capped forward at
danube's prefill and at D = 96 and 128, the capped backward at danube's
training shape, batch 1: errors against the plain version and float64,
times beside the uncapped kernels; flex_attention is not timed), after six
small cases of the capped kernels against a float64 plain version: caps of
50, 30 and 1 on q and k scaled ×8 (where the cap saturates) and a cap of 1
at ×1 and ×2 (danube's decode consistency's regime).  With ``--child`` it
is the per-tree process.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

SMALL = (((1, 4, 2, 200, 64), True, 0, 50.0, 8.0),
         ((1, 4, 1, 300, 80), True, 100, 50.0, 8.0),
         ((1, 4, 2, 270, 128), True, 77, 30.0, 8.0),
         ((1, 4, 2, 190, 80), True, 0, 1.0, 8.0),
         ((1, 4, 2, 190, 80), True, 0, 1.0, 1.0),
         ((1, 4, 2, 190, 80), True, 0, 1.0, 2.0))


def child(root: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention, flash_attention_ref
    from repro_torch.kernels._build import build_all
    t0 = time.perf_counter()
    build_all()
    print(f"[cap_compare] {root}: built in {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rel(a, w):
        a, w = a.detach().double(), w.detach().double()
        return float((a - w).abs().max() / w.abs().max())
    for (b, h, kv, s, d), causal, window, cap, amp in SMALL:
        q, k = (torch.randn(b, n, s, d, generator=gen, device="cuda") * amp
                for n in (h, kv))
        v = torch.randn(b, kv, s, d, generator=gen, device="cuda")
        dout = torch.randn(b, h, s, d, generator=gen, device="cuda")
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
        got = torch.autograd.grad(out, (q, k, v), dout)
        ref = flash_attention_ref(q.double(), k.double(), v.double(),
                                  causal=causal, window=window, softcap=cap)
        want = torch.autograd.grad(ref, (q, k, v), dout.double())
        print(f"[cap_compare] {(b, h, kv, s, d)} causal={causal} "
              f"window={window} softcap {cap:g}, q and k x{amp:g}: against "
              f"float64, forward {rel(out, ref):.3e}, dq dk dv "
              + ", ".join(f"{rel(g, w):.3e}" for g, w in zip(got, want)))
    cs.SOFTCAP_FWD_CASES = tuple(c for c in cs.SOFTCAP_FWD_CASES
                                 if c[2] == "float32")
    cs.SOFTCAP_BWD_CASES = tuple(c for c in cs.SOFTCAP_BWD_CASES
                                 if c[2] == "float32")
    cs.flex_softcap = lambda *a: (None, "not timed here")
    cs.softcap_checks(torch)
    print(f"[cap_compare] {root}: card {cs.card_line()}; done in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child(argv[1])
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv + argv[::-1]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", tree], capture_output=True, text=True)
        print(f"===== {tree}: rc {r.returncode}")
        print("\n".join(line for line in r.stdout.splitlines()
                        if not line.startswith("[build]")))
        if r.returncode:
            print(r.stderr[-4000:])
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
