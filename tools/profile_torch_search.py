#!/usr/bin/env python3
"""Where one search episode of the PyTorch port spends its time, on one GPU.

    python3 tools/profile_torch_search.py [--graph inception_v3]

Runs the main path's episode (``HSDAG.search`` with ``engine="level"``:
window rollout → window scoring → Eq.-14 replay and Adam update) at the
Table-6 widths with 16 chains, phase by phase with the host clock around
synchronised work, median of 3 episodes after one warm-up.  Then profiles
one more episode with ``torch.profiler`` and prints the device time by kernel, the number of
kernel launches, and the device's busy and idle shares of the episode.
Needs a CUDA device; imports nothing of the JAX package.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph", default="inception_v3",
                    choices=["inception_v3", "resnet50", "bert_base"])
    args = ap.parse_args()
    episodes = 3

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_search: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import (HSDAG, HSDAGConfig, PAPER_BENCHMARKS,
                             extract_features, paper_platform)
    from repro_torch.core.reinforce import step_weights
    from repro_torch.core.sim import ChainStreams, RewardPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    g = PAPER_BENCHMARKS[args.graph]()
    arrays = extract_features(g)
    cfg = HSDAGConfig(batch_chains=16, engine="level")
    agent = HSDAG(cfg)
    agent.init(arrays)
    pipe = RewardPipeline.from_platform(g, paper_platform(), "level")
    engine = agent.rollout_engine(arrays)
    streams = ChainStreams(cfg.seed, cfg.batch_chains, agent.device)
    state = {"z": engine.x0.expand(cfg.batch_chains, *engine.x0.shape),
             "first": True}

    def episode():
        """One episode of HSDAG.search's loop → seconds per phase."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z1, record, fines, _ = engine.rollout_window(
            state["z"], num_steps=cfg.update_timestep,
            start_first=state["first"], streams=streams)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rewards, _ = pipe.score_window(fines)
        t2 = time.perf_counter()
        w = step_weights(rewards.T, cfg.gamma).T.copy()
        agent.apply_grads(engine.window_grads(
            state["z"], record, torch.as_tensor(w, device=agent.device),
            start_first=state["first"]))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        state["z"], state["first"] = z1, False
        return {"rollout": t1 - t0, "score": t2 - t1, "replay+update": t3 - t2,
                "episode": t3 - t0}

    episode()                                   # warm-up
    runs = [episode() for _ in range(episodes)]
    print(f"card: {card}")
    print(f"{args.graph} V={g.num_nodes} B={cfg.batch_chains} "
          f"T={cfg.update_timestep} hidden={cfg.hidden_channel}; host clock, "
          f"median of {episodes} episodes after one warm-up:")
    for phase in runs[0]:
        vals = [r[phase] for r in runs]
        print(f"  {phase:14s} {statistics.median(vals) * 1e3:10.3f} ms  "
              f"(runs: {', '.join(f'{v * 1e3:.3f}' for v in vals)})")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = episode()["episode"]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("aten::equal", "aten::item",
                             "aten::_local_scalar_dense"))
    print(f"profiled episode: wall {wall * 1e3:.3f} ms (profiler on), "
          f"{launches} kernel launches, device busy {busy_us / 1e3:.3f} ms "
          f"= {busy_us / 1e6 / wall:.1%} of wall, idle "
          f"{1 - busy_us / 1e6 / wall:.1%}; host syncs (equal/item) {syncs}")
    if not kernels:
        print("torch.profiler recorded no device time: device shares not "
              "measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
