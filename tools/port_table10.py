#!/usr/bin/env python3
"""Table 10 (``benchmarks/table10_sharded.py``) on the port: sharded corpus
training throughput and streaming-corpus memory.

    python3 tools/port_table10.py [--device cuda|cpu] [--cpu-ranks 1,2,4]
                                  [--episodes 2] [--counts 24,240]

Prints the reference's CSV rows (``name,us_per_call,derived``):

* **throughput** — corpus training placements/s at the reference child's
  configuration (``HSDAGConfig(num_devices=2, hidden_channel=32,
  update_timestep=10, batch_chains=4, max_episodes=1)`` over
  ``synthetic:family=mixed:count=8:size=24:seed=0``, ``max_buckets=1``,
  ``graphs_per_episode=4``): one warm-up ``train_corpus``, then a measured
  one of ``--episodes`` episodes, placements = episodes × T × 4 × B over its
  wall.  One row on ``--device`` (the card by default) at
  ``mesh_shape=(1, 1)`` on a process group of one rank (NCCL on the card,
  gloo on the CPU), so the row runs the sharded engine and its collectives
  (the reference runs ``mesh_shape=None`` on one device), and, with
  ``--cpu-ranks``, one row a rank count on the CPU: 1, 2 and 4 gloo ranks
  run meshes 1×1, 1×2 and 2×2 (each rank a process, ``cores // ranks``
  threads each, meeting over a FileStore), as the reference's virtual host
  devices.  Ranks on one host share its cores: a row's speedup over one
  rank is the host work split over processes, not a several-card one.
* **memory** — peak Python heap (tracemalloc, from after the imports, so
  the corpus's own allocations; the reference's also holds its imports')
  and peak RSS of an eager ``build_corpus`` + full featurization against a
  ``stream:`` corpus pass (LRU ``cache_graphs=8``) at ``--counts``
  synthetic graphs of size 150, each in a fresh process (all started
  together; the 240-graph rows take about a minute, most of it
  tracemalloc's cost).  The child processes run before this one touches
  the card, since a child's peak RSS also holds its parent's.

A several-card mesh (``torchrun --nproc-per-node=N`` on N cards over NCCL)
is not run here: the script measures the card row, the CPU rows and the
memory rows.
"""
from __future__ import annotations

import argparse
import os
import resource
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

#: the reference child's corpus, config and trainer arguments
THROUGHPUT_SPEC = "synthetic:family=mixed:count=8:size=24:seed=0"
THROUGHPUT_CONFIG = {"num_devices": 2, "hidden_channel": 32,
                     "update_timestep": 10, "batch_chains": 4,
                     "max_episodes": 1}
THROUGHPUT_TRAINER = {"max_buckets": 1, "graphs_per_episode": 4}
#: rank count → the reference's ("graphs", "chains") factorization
MESHES = {1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4)}
MEMORY_SPEC = "synthetic:family=mixed:count={count}:size=150:seed=0"
MEMORY_CACHE = 8


def peak_rss_mb() -> float:
    """This process's peak resident set in MB: ``VmHWM`` where Linux has
    it (``ru_maxrss`` of a child started by a large process still holds
    the parent's peak, which survives ``exec``), else ``ru_maxrss``."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _sync(device: str) -> None:
    import torch
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def throughput(gm: int, bm: int, episodes: int, device: str):
    """One throughput row at ``mesh_shape=(gm, bm)`` in this process, a
    rank of a process group of gm·bm ranks → (placements/s, peak RSS MB,
    measured wall s)."""
    from repro_torch.core import HSDAGConfig, paper_platform
    from repro_torch.core.train.curriculum import CurriculumTrainer
    from repro_torch.graphs import build_corpus
    cfg = HSDAGConfig(**THROUGHPUT_CONFIG)
    corpus = build_corpus(THROUGHPUT_SPEC)
    trainer = CurriculumTrainer(cfg, mesh_shape=(gm, bm), device=device,
                                **THROUGHPUT_TRAINER)
    trainer.train_corpus(corpus, platform=paper_platform())    # warm-up
    _sync(device)
    t0 = time.perf_counter()
    trainer.train_corpus(corpus, platform=paper_platform(),
                         episodes=episodes)
    _sync(device)
    wall = time.perf_counter() - t0
    placements = (episodes * cfg.update_timestep
                  * THROUGHPUT_TRAINER["graphs_per_episode"]
                  * cfg.batch_chains)
    return placements / wall, peak_rss_mb(), wall


def _rank(rank: int, world: int, store: str, episodes: int) -> None:
    """One CPU rank of a ``world``-rank throughput row."""
    import torch
    import torch.distributed as dist
    threads = max(1, (os.cpu_count() or 1) // world)
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    try:
        gm, bm = MESHES[world]
        pps, rss_mb, wall = throughput(gm, bm, episodes, "cpu")
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(f"RESULT,{pps!r},{rss_mb!r},{wall!r},{threads}")


def _child(args):
    """Run this script with ``args`` in a fresh process → the Popen."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             *map(str, args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc, timeout: float = 1800.0) -> list:
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"table10 child failed ({proc.returncode}):\n"
                           f"{err[-3000:]}")
    for line in out.splitlines():
        if line.startswith("RESULT,"):
            return line.split(",")[1:]
    return []


def cpu_row(world: int, episodes: int):
    """A CPU throughput row of ``world`` gloo ranks → (placements/s, rank
    0's peak RSS MB, wall s, threads a rank)."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [_child(["--rank", r, "--world", world, "--store", store,
                         "--episodes", episodes]) for r in range(world)]
        try:
            results = [_result(p) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    pps, rss_mb, wall, threads = results[0]
    return float(pps), float(rss_mb), float(wall), int(threads)


def _memory(count: int, stream: bool) -> None:
    """One memory row's child: featurize the corpus once, eagerly or
    streaming.  The heap is traced from after the imports, so the row
    holds the corpus's own allocations (the reference traces its imports
    too)."""
    import tracemalloc
    from repro_torch.core.features import (extract_features,
                                           shared_feature_config)
    from repro_torch.graphs import build_corpus
    tracemalloc.start()
    spec = MEMORY_SPEC.format(count=count)
    if stream:
        corpus = build_corpus(spec, stream=True, cache_graphs=MEMORY_CACHE)
        fc = shared_feature_config(corpus.meta)
        for i in range(len(corpus)):               # one full featurize pass
            extract_features(corpus[i], fc)
    else:
        corpus = build_corpus(spec)
        fc = shared_feature_config(corpus)
        arrays = [extract_features(g, fc) for g in corpus]  # noqa: F841
    peak_kb = tracemalloc.get_traced_memory()[1] / 1024.0
    print(f"RESULT,{peak_kb!r},{peak_rss_mb()!r}")


def start_memory(counts) -> dict:
    """Start the memory rows' processes, all together → {(count,
    stream): Popen}; :func:`collect_memory` reads them."""
    return {(c, s): _child(["--memory", c] + (["--stream"] if s else []))
            for c in counts for s in (False, True)}


def memory_rows(counts) -> dict:
    """{(count, stream): (peak heap KB of the corpus work, peak RSS MB)},
    each from its own process, all started together."""
    return collect_memory(start_memory(counts))


def collect_memory(procs) -> dict:
    """:func:`start_memory`'s processes → their rows."""
    try:
        return {k: tuple(float(v) for v in _result(p))
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


def throughput_line(label: str, n: int, pps: float, base: float,
                    rss_mb: float, extra: str = "") -> str:
    gm, bm = MESHES[n]
    return (f"port_table10_sharded_throughput_{label}_d{n}_mesh{gm}x{bm},"
            f"{1e6 / max(pps, 1e-9)!r},placements_per_s={pps!r};"
            f"speedup_vs_d1={pps / base!r}x;"
            f"physical_cores={os.cpu_count() or 1};rss_mb={rss_mb!r}{extra}")


def memory_lines(rows: dict) -> list:
    return [f"port_table10_{'stream' if s else 'eager'}_corpus_mem_n{c},"
            f"{kb!r},peak_heap_kb={kb!r};rss_mb={mb!r};graphs={c};"
            f"col=us_per_call_holds_peak_heap_kb"
            for (c, s), (kb, mb) in sorted(rows.items())]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu-ranks", default="",
                    help="comma-separated gloo rank counts, e.g. 1,2,4")
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--counts", default="24,240")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    ap.add_argument("--memory", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--stream", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, SRC)
    if args.rank is not None:
        _rank(args.rank, args.world, args.store, args.episodes)
        return 0
    if args.memory is not None:
        _memory(args.memory, args.stream)
        return 0

    # The child processes' rows first, while this process is small: a
    # child's ru_maxrss also holds its parent's peak at the fork.
    lines, base = [], None
    for n in [int(c) for c in args.cpu_ranks.split(",") if c]:
        cpps, crss, _, threads = cpu_row(n, args.episodes)
        base = cpps if base is None else base
        lines.append(throughput_line("cpu", n, cpps, base, crss,
                                     f";threads_per_rank={threads}"))
    counts = [int(c) for c in args.counts.split(",") if c]
    lines += memory_lines(memory_rows(counts))

    import torch
    from repro_torch._device import resolve_device
    device = resolve_device(args.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"# device {kind}; torch {torch.__version__}")
    print("name,us_per_call,derived")
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
            world_size=1)
        try:
            pps, rss_mb, _ = throughput(1, 1, args.episodes, str(device))
        finally:
            dist.destroy_process_group()
    print(throughput_line(device.type, 1, pps, pps, rss_mb,
                          f";device={kind}"))
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
