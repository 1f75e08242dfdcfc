#!/usr/bin/env python3
"""Where LM training in the PyTorch port spends its time, on one GPU.

    python3 tools/profile_torch_train.py [--arch h2o-danube-1.8b]
        [--global-batch 4] [--seq 8192] [--steps 2]

Builds the step ``repro_torch.launch.train`` runs (random weights from seed
0, ``adamw(linear_warmup_cosine(3e-4, 10, 100), weight_decay=0.01)``,
``make_train_step(cfg, opt, ssd_chunk=32)``, ``SyntheticTokens`` seed 11) at
the arch's full width and depth in bf16 with remat "full", takes one
warm-up step, times ``--steps`` steps on the host clock (synchronised), then
profiles one step with ``torch.profiler``: kernel launches, the device's
busy and idle shares, device time by kernel, and the shares of the
backward kernels (``csrc/flash_attention_bwd.cu``, ``rmsnorm_bwd_*``,
``ssd_scan_bwd_*``), of the forward kernels and of the rest; CUDA events
around the optimizer's update give its share.  With no ``--arch`` it runs
h2o-danube-1.8b (4 × 8192) and mamba2-130m (8 × 4096).  Needs a CUDA device;
imports nothing of the JAX package.
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

DEFAULT_SHAPE = {"h2o-danube-1.8b": (4, 8192), "mamba2-130m": (8, 4096)}
#: kernel-name fragments of the port's hand-written kernels
BACKWARD = ("flash_bwd_", "rmsnorm_bwd_", "ssd_scan_bwd_")
FORWARD = ("flash_attention_sm90", "flash_attention_kernel", "rmsnorm_",
           "ssd_scan_kernel")


def _share(kernels, fragments):
    return sum(e.self_device_time_total for e in kernels
               if any(f in e.key for f in fragments)) / 1e6


def profile_arch(torch, arch: str, batch: int, seq: int, steps: int):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import TrainState, init_params, make_train_step
    from repro_torch.optim import (GradientTransform, adamw,
                                   linear_warmup_cosine)
    cfg = get(arch).config
    opt = adamw(linear_warmup_cosine(3e-4, 10, 100), weight_decay=0.01)
    spans = []

    def update(grads, state, params=None):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = opt.update(grads, state, params)
        end.record()
        spans.append((start, end))
        return out
    step = make_train_step(cfg, GradientTransform(opt.init, update),
                           ssd_chunk=32)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq, batch, seed=11),
                           "cuda")
    params = init_params(cfg, seed=0, device="cuda")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    del params
    state, _ = step(state, data.batch(0))               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, data.batch(1 + i))
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    print(f"{arch} {cfg.dtype} remat={cfg.remat_policy if cfg.remat else 'off'}"
          f" B={batch} S={seq}: step median {wall * 1e3:.1f} ms over "
          f"{steps} steps (runs: {', '.join(f'{t * 1e3:.1f}' for t in times)}"
          f") = {batch * seq / wall:.0f} tok/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    batch_next = data.batch(1 + steps)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch_next)
        float(m["loss"])
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("  torch.profiler recorded no device time: device shares not "
              "measured")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    opt_s = sum(s.elapsed_time(e) for s, e in spans) / 1e3
    bwd, fwd = _share(kernels, BACKWARD), _share(kernels, FORWARD) - \
        _share(kernels, ("rmsnorm_bwd_",))
    print(f"  profiled step: wall {pwall * 1e3:.1f} ms (profiler on), "
          f"{launches} kernel launches, device busy {busy * 1e3:.1f} ms = "
          f"{busy / pwall:.1%} of wall, idle {1 - busy / pwall:.1%}")
    print(f"  backward kernels {bwd * 1e3:.1f} ms ({bwd / busy:.1%} of busy);"
          f" forward kernels {fwd * 1e3:.1f} ms ({fwd / busy:.1%}); "
          f"optimizer update {opt_s * 1e3:.1f} ms ({opt_s / pwall:.1%} of "
          f"wall, CUDA events); everything else {busy - bwd - fwd:.3f} s")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:10.3f} ms  "
              f"{e.count:6d}x  {e.key[:90]}")
    del state
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(DEFAULT_SHAPE))
    ap.add_argument("--global-batch", type=int)
    ap.add_argument("--seq", type=int)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    for arch in [args.arch] if args.arch else sorted(DEFAULT_SHAPE):
        b, s = DEFAULT_SHAPE[arch]
        profile_arch(torch, arch, args.global_batch or b, args.seq or s,
                     args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
