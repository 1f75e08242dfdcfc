"""Time the port's float32 flash attention beside PyTorch's own float32
attention (the card is needed).

    python3 tools/flash_f32_timing.py [--json OUT]

At each shape of ``SHAPES`` (batch 1 of h2o-danube-1.8b's prefill and
training shapes, phi3-mini's and olmoe-1b-7b's prefills) it times
``repro_torch.kernels.flash_attention`` on float32 inputs (the forward, or
the backward alone: ``torch.autograd.grad`` on one graph) in turns with
``scaled_dot_product_attention`` on the same inputs (bool mask, enable_gqa,
TF32 off: kernel, library, library, kernel), and prints each time with the
library's and the kernel's normwise distance from the plain version
(``flash_attention_ref``; the forward only).  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: ((B, H, KV, S, D), window, "forward" or "backward"); causal throughout
SHAPES = (((1, 32, 8, 4608, 80), 4096, "forward"),
          ((1, 32, 32, 4064, 96), 0, "forward"),
          ((1, 16, 16, 4064, 128), 0, "forward"),
          ((1, 32, 8, 8192, 80), 4096, "backward"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the rows to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_f32_timing: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from chip_smoke import card_line, cuda_ms, rel_err
    from repro_torch.kernels import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention import flash_mask
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(30)
    rows = []
    for (b, h, kv, s, d), window, way in SHAPES:
        q = torch.randn(b, h, s, d, generator=gen, device="cuda")
        k = torch.randn(b, kv, s, d, generator=gen, device="cuda")
        v = torch.randn(b, kv, s, d, generator=gen, device="cuda")
        mask = flash_mask(s, True, window, "cuda")

        def ours(q, k, v):
            return flash_attention(q, k, v, window=window)

        def lib(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        row = {"shape": [b, h, kv, s, d], "window": window, "way": way}
        if way == "forward":
            want = flash_attention_ref(q, k, v, window=window)
            row["kernel_err"] = rel_err(torch, ours(q, k, v), want)
            row["library_err"] = rel_err(torch, lib(q, k, v), want)
            del want
            runs = {"kernel": lambda: ours(q, k, v),
                    "library": lambda: lib(q, k, v)}
        else:
            dout = torch.randn(b, h, s, d, generator=gen, device="cuda")
            ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
            graphs = {"kernel": ours(*ins), "library": lib(*ins)}
            runs = {name: (lambda o=o: torch.autograd.grad(
                o, ins, dout, retain_graph=True))
                for name, o in graphs.items()}
        times = {"kernel": [], "library": []}
        for name in ("kernel", "library", "library", "kernel"):
            times[name].append(cuda_ms(torch, runs[name], 5, 1)[0])
        row.update({f"{name}_ms": min(t) for name, t in times.items()})
        row["runs_ms"] = times
        print(f"[flash_f32] {json.dumps(row)}", flush=True)
        rows.append(row)
        del q, k, v, mask, runs
        torch.cuda.empty_cache()
    card = card_line()
    print(f"[card] {card}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "rows": rows},
                                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
