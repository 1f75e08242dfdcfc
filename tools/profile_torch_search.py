#!/usr/bin/env python3
"""Where one search episode of the PyTorch port spends its time, on one GPU.

    python3 tools/profile_torch_search.py [--graph inception_v3] [--engine E]
    python3 tools/profile_torch_search.py --multi
    python3 tools/profile_torch_search.py --corpus

Runs the main path's episode (``HSDAG.search``'s loop with the reward of
``--engine``, by default the config's default, ``"auto"``: the ``scan``
backend; ``--engine level`` for the level backend; window rollout → window
scoring → Eq.-14 replay and Adam update) at the
Table-6 widths with 16 chains, phase by phase with the host clock around
synchronised work, median of 3 episodes after one warm-up.  ``--multi``
runs a joint episode of ``train_multi`` instead, at Table 7's config
(``HSDAGConfig(num_devices=2, batch_chains=8, update_timestep=10)`` over
Inception-v3, ResNet-50 and BERT-base, the per-graph reward norm).
``--corpus`` runs corpus episodes of ``CurriculumTrainer.train_corpus`` at
Table 8's config (that config, ``max_buckets=3, graphs_per_episode=4``,
over Table 8's corpus less its ``traced`` entry): the stratified sampler
cycles through the three buckets, so each phase is reported for each
bucket's episode (median of 3 cycles after one warm-up cycle), with the
host batch build ("batch") and the slots' device data ("slots") as phases
of their own, and one cycle is profiled.  Then profiles one more episode
(one cycle for ``--corpus``) with ``torch.profiler`` and prints the device
time by kernel, the number of kernel launches, and the device's busy and
idle shares.
Needs a CUDA device; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def joint_episode(torch, engine_name):
    """A joint episode of ``train_multi`` at Table 7's config → (a function
    that runs one and returns seconds per phase, its description)."""
    from repro_torch import (HSDAG, HSDAGConfig, PAPER_BENCHMARKS,
                             paper_platform)
    from repro_torch.core.train import window_weights
    cfg = HSDAGConfig(num_devices=2, batch_chains=8, update_timestep=10)
    if engine_name is not None:
        cfg = dataclasses.replace(cfg, engine=engine_name)
    graphs = [PAPER_BENCHMARKS[n]()
              for n in ("inception_v3", "resnet50", "bert_base")]
    agent = HSDAG(cfg)
    runner, stream, _ = agent.joint_runner(graphs, platform=paper_platform())
    engine, pipe = runner.engine, runner.pipeline

    def episode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, records, fines, _ = engine.rollout_window(
            stream.z, num_steps=cfg.update_timestep,
            start_first=stream.first, streams=stream.streams)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rewards, _ = pipe.score_window(fines)
        t2 = time.perf_counter()
        w = window_weights(rewards, cfg, reward_norm="pergraph")
        agent.apply_grads(engine.window_grads(
            stream.z, records, torch.as_tensor(w, device=agent.device),
            start_first=stream.first))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        stream.z, stream.first = z, False
        return {"rollout": t1 - t0, "score": t2 - t1, "replay+update": t3 - t2,
                "episode": t3 - t0}
    what = (f"joint episode over {'+'.join(g.name for g in graphs)} "
            f"(V {'/'.join(str(g.num_nodes) for g in graphs)}) B="
            f"{cfg.batch_chains} engine {cfg.engine} T={cfg.update_timestep} "
            f"hidden={cfg.hidden_channel}")
    return episode, what


#: Table 8's corpus without its traced entry (benchmarks/table8_corpus.py)
CORPUS = ("benchmark:names=inception_v3+resnet50;"
          "lm:archs=qwen1.5-0.5b+mamba2-130m:seq_len=1024;"
          "synthetic:family=layered+series_parallel:count=6:size=40:seed=0")


def corpus_episode(torch, engine_name):
    """Corpus episodes of ``train_corpus`` at Table 8's config → (a function
    that runs the next episode and returns seconds per phase, keyed by its
    bucket, its description)."""
    from repro_torch import (CurriculumTrainer, HSDAGConfig, build_corpus,
                             paper_platform)
    from repro_torch.core.train import window_weights
    cfg = HSDAGConfig(num_devices=2, batch_chains=8, update_timestep=10)
    if engine_name is not None:
        cfg = dataclasses.replace(cfg, engine=engine_name)
    trainer = CurriculumTrainer(cfg, max_buckets=3, graphs_per_episode=4)
    corpus = build_corpus(CORPUS)
    run = trainer._start(corpus, paper_platform(), None)
    count = {"episode": 0}

    def episode():
        e = count["episode"]
        count["episode"] += 1
        bi, ids = run.sampler.sample()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = run.build(ids)
        t1 = time.perf_counter()
        engine, pipe, stream = trainer._episode_parts(run, e, bi, ids,
                                                      payload)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        z, records, fines, _ = engine.rollout_window(
            stream.z, num_steps=cfg.update_timestep, start_first=True,
            streams=stream.streams)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rewards, latencies = pipe.score_window(fines)
        t4 = time.perf_counter()
        run.tracker.update([f.cpu().numpy() for f in fines], rewards,
                           latencies, None, ids)
        w = window_weights(rewards, cfg, reward_norm="pergraph")
        trainer.apply_grads(engine.window_grads(
            stream.z, records, torch.as_tensor(w, device=trainer.device),
            start_first=True))
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        run.sampler.observe(ids, run.tracker.best_latencies)
        return bi, {"batch": t1 - t0, "slots": t2 - t1, "rollout": t3 - t2,
                    "score": t4 - t3, "replay+update": t5 - t4,
                    "episode": t5 - t0}
    sizes = [g.num_nodes for g in corpus]
    what = (f"corpus episodes over Table 8's corpus ({len(corpus)} graphs, "
            f"buckets {run.buckets}, V {sizes}), 4 slots an episode, B="
            f"{cfg.batch_chains} engine {cfg.engine} T={cfg.update_timestep} "
            f"hidden={cfg.hidden_channel}")
    return episode, what


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph", default="inception_v3",
                    choices=["inception_v3", "resnet50", "bert_base"])
    ap.add_argument("--engine", default=None,
                    help="an engine of HSDAGConfig with a platform reward "
                         "(default: the config's default)")
    ap.add_argument("--multi", action="store_true",
                    help="a joint episode of train_multi at Table 7's "
                         "config over the three paper graphs")
    ap.add_argument("--corpus", action="store_true",
                    help="corpus episodes of train_corpus at Table 8's "
                         "config, one a bucket")
    args = ap.parse_args()
    episodes = 3

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_search: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import (HSDAG, HSDAGConfig, PAPER_BENCHMARKS,
                             extract_features, paper_platform)
    from repro_torch.core.hsdag import reward_backend
    from repro_torch.core.reinforce import step_weights
    from repro_torch.core.sim import ChainStreams, RewardPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    g = PAPER_BENCHMARKS[args.graph]()
    arrays = extract_features(g)
    cfg = HSDAGConfig(batch_chains=16)
    if args.engine is not None:
        cfg = dataclasses.replace(cfg, engine=args.engine)
    backend = reward_backend(cfg.engine)
    agent = HSDAG(cfg)
    agent.init(arrays)
    pipe = RewardPipeline.from_platform(g, paper_platform(), backend)
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

    if args.corpus:
        return corpus_main(torch, profile, ProfilerActivity, card,
                           args.engine, episodes)
    if args.multi:
        episode, what = joint_episode(torch, args.engine)
    else:
        what = (f"{args.graph} V={g.num_nodes} B={cfg.batch_chains} engine "
                f"{cfg.engine} (reward: the {backend} backend) "
                f"T={cfg.update_timestep} hidden={cfg.hidden_channel}")
    episode()                                   # warm-up
    runs = [episode() for _ in range(episodes)]
    print(f"card: {card}")
    print(f"{what}; host clock, median of {episodes} episodes after one "
          f"warm-up:")
    for phase in runs[0]:
        vals = [r[phase] for r in runs]
        print(f"  {phase:14s} {statistics.median(vals) * 1e3:10.3f} ms  "
              f"(runs: {', '.join(f'{v * 1e3:.3f}' for v in vals)})")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = episode()["episode"]
    report(torch, prof, wall, "profiled episode")
    return 0


def corpus_main(torch, profile, ProfilerActivity, card, engine_name,
                cycles) -> int:
    """``--corpus``: one warm-up cycle of the three buckets, ``cycles``
    timed cycles, then one profiled cycle."""
    episode, what = corpus_episode(torch, engine_name)
    for _ in range(3):
        episode()                               # warm-up cycle
    runs: dict = {}
    for _ in range(3 * cycles):
        bi, phases = episode()
        runs.setdefault(bi, []).append(phases)
    print(f"card: {card}")
    print(f"{what}; host clock, median of {cycles} episodes of each bucket "
          f"after one warm-up cycle:")
    for bi in sorted(runs):
        print(f"  bucket {bi}:")
        for phase in runs[bi][0]:
            vals = [r[phase] for r in runs[bi]]
            print(f"    {phase:14s} {statistics.median(vals) * 1e3:10.3f} ms"
                  f"  (runs: {', '.join(f'{v * 1e3:.3f}' for v in vals)})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = sum(episode()[1]["episode"] for _ in range(3))
    report(torch, prof, wall, "profiled cycle (one episode a bucket)")
    return 0


def report(torch, prof, wall, label) -> None:
    """Device time by kernel, launches, host syncs and the device's busy
    share of ``wall`` seconds, from a ``torch.profiler`` run."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("aten::equal", "aten::item",
                             "aten::_local_scalar_dense"))
    print(f"{label}: wall {wall * 1e3:.3f} ms (profiler on), "
          f"{launches} kernel launches, device busy {busy_us / 1e3:.3f} ms "
          f"= {busy_us / 1e6 / wall:.1%} of wall, idle "
          f"{1 - busy_us / 1e6 / wall:.1%}; host syncs (equal/item) {syncs}")
    if not kernels:
        print("torch.profiler recorded no device time: device shares not "
              "measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
