#!/usr/bin/env python3
"""Where LM serving in the PyTorch port spends its time, on one GPU.

    python3 tools/profile_torch_serve.py [--arch h2o-danube-1.8b] [--batch 4]
        [--prompt 4608] [--steps 8]

Runs the serve path of ``repro_torch.launch.serve`` (prefill with SSD chunk
32, then greedy decode steps) at the arch's full width in bf16 with random
weights from seed 0, after one warm-up of each phase.  Prints the prefill
time and the per-step decode times (host clock around synchronised work),
then profiles one prefill and the decode steps with ``torch.profiler``:
device time by kernel, kernel launches, and the device's busy and idle
shares of each phase.  With no ``--arch`` it runs h2o-danube-1.8b (prompt
4608) and mamba2-130m (prompt 4096).  Needs a CUDA device; imports nothing
of the JAX package.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

DEFAULT_PROMPT = {"h2o-danube-1.8b": 4608, "mamba2-130m": 4096}


def _profile(torch, fn):
    """Run ``fn`` under the profiler → (wall s, device kernels, launches,
    busy s)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    return wall, kernels, sum(e.count for e in kernels), busy


def profile_arch(torch, arch: str, batch: int, prompt: int, steps: int):
    from repro_torch.configs import get
    from repro_torch.models import init_params, make_serve_step, prefill
    cfg = get(arch).config
    params = init_params(cfg, seed=0, device="cuda")
    serve_step = make_serve_step(cfg)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         dtype=torch.int32).cuda()
    max_len = prompt + 2 * steps + 2

    def run_prefill():
        return prefill(params, cfg, toks, max_len=max_len, ssd_chunk=32)

    def run_decode(caches, tok, start):
        times = []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, _, caches = serve_step(params, caches, tok, start + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times, caches, tok

    with torch.inference_mode():
        logits, caches = run_prefill()                  # warm-up
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        run_decode(caches, tok, prompt)                 # warm-up
        del logits, caches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = run_prefill()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        del logits
        times, caches, tok = run_decode(caches, tok, prompt)
        step_s = statistics.median(times)
        print(f"{arch} {cfg.dtype} B={batch} prompt={prompt}: prefill "
              f"{prefill_s * 1e3:.3f} ms; decode step median "
              f"{step_s * 1e3:.3f} ms over {steps} steps (runs: "
              f"{', '.join(f'{t * 1e3:.3f}' for t in times)}) = "
              f"{batch / step_s:.1f} tok/s")
        del caches
        torch.cuda.empty_cache()

        phases = {}
        phases["prefill"] = _profile(torch, run_prefill)
        logits, caches = run_prefill()
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        del logits
        phases[f"decode x{steps}"] = _profile(
            torch, lambda: run_decode(caches, tok, prompt))
    for name, (wall, kernels, launches, busy) in phases.items():
        print(f"  profiled {name}: wall {wall * 1e3:.3f} ms (profiler on), "
              f"{launches} kernel launches, device busy {busy * 1e3:.3f} ms "
              f"= {busy / wall:.1%} of wall, idle {1 - busy / wall:.1%}")
        if not kernels:
            print("  torch.profiler recorded no device time: device shares "
                  "not measured")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"{e.count:6d}x  {e.key[:90]}")
    del params, caches
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(DEFAULT_PROMPT))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    for arch in [args.arch] if args.arch else sorted(DEFAULT_PROMPT):
        profile_arch(torch, arch, args.batch,
                     args.prompt or DEFAULT_PROMPT[arch], args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
