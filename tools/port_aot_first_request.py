#!/usr/bin/env python3
"""Does the port's AOT preload move a fresh process's first request?

    python3 tools/port_aot_first_request.py [--rounds 2] [--device cuda]

Fits a corpus policy over the three paper graphs (``chip_smoke.py``'s
``[service]`` config at one episode), saves it, and serves each paper graph
once through a ``PlacementService`` with an AOT directory, which stores one
blob a bucket.  Then it starts fresh Python processes in turns, cold, aot,
aot, cold in each round: each loads the checkpoint into a
``PlacementService`` and times two ``place()`` calls of each paper graph,
"cold" without the AOT directory and "aot" with it (the first request of
each bucket then preloads the bucket's blob: its checks and the kernel
library's load).  Each process prints one JSON line; the parent prints
them and the median first-request time of each kind by graph.  On the card
unless ``--device cpu``; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
sys.path.insert(0, SRC)

CONFIG = {"num_devices": 2, "batch_chains": 8, "max_episodes": 1,
          "update_timestep": 10}
SERVICE_KW = {"batch_slots": 4, "size_granularity": 16}


def child(mode: str, ckpt: str, aot_dir: str, device: str) -> None:
    """One fresh process: load, then two requests of each paper graph."""
    t0 = time.perf_counter()
    import torch
    from repro_torch.api import PlacementService
    from repro_torch.graphs import PAPER_BENCHMARKS
    t_import = time.perf_counter() - t0
    t0 = time.perf_counter()
    service = PlacementService(ckpt, device=device,
                               aot_cache=aot_dir if mode == "aot" else None,
                               **SERVICE_KW)
    t_load = time.perf_counter() - t0
    walls = {}
    for name, build in PAPER_BENCHMARKS.items():
        g = build()
        walls[name] = []
        for _ in range(2):
            t0 = time.perf_counter()
            service.place(g)
            walls[name].append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"mode": mode, "import_s": t_import, "load_s": t_load,
                      "request_ms": walls, "stats": service.stats(),
                      "device": (torch.cuda.get_device_name(0)
                                 if device == "cuda" else "cpu")}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--child", nargs=3, metavar=("MODE", "CKPT", "AOT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(*args.child, args.device)
        return 0

    from repro_torch import HSDAGConfig
    from repro_torch.api import (PlacementService, PlacementSession,
                                 PlacementSpec)
    with tempfile.TemporaryDirectory() as d:
        ckpt, aot_dir = os.path.join(d, "policy"), os.path.join(d, "aot")
        session = PlacementSession(PlacementSpec(
            workload="benchmark", mode="corpus",
            config=HSDAGConfig(**CONFIG), max_buckets=3,
            graphs_per_episode=2), device=args.device)
        session.fit(rng=0)
        session.save(ckpt)
        warm = PlacementService(ckpt, aot_cache=aot_dir, device=args.device,
                                **SERVICE_KW)
        warm.place_many(session.graphs)
        print(f"stored {warm.stats()['aot_stores']} blobs")
        runs = []
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
        for _ in range(args.rounds):
            for mode in ("cold", "aot", "aot", "cold"):
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--device",
                     args.device, "--child", mode, ckpt, aot_dir],
                    capture_output=True, text=True, env=env, timeout=600)
                if proc.returncode != 0:
                    print(proc.stderr, file=sys.stderr)
                    return 1
                run = json.loads(proc.stdout.strip().splitlines()[-1])
                run["process_s"] = time.perf_counter() - t0
                print(json.dumps(run))
                runs.append(run)
    for run in runs:
        cold = run["stats"]["shape_keys_seen"]
        if (cold == 0) != (run["mode"] == "aot"):
            print(f"a {run['mode']} process decoded {cold} buckets cold",
                  file=sys.stderr)
            return 1
    for name in runs[0]["request_ms"]:
        line = []
        for mode in ("cold", "aot"):
            first = [r["request_ms"][name][0] for r in runs
                     if r["mode"] == mode]
            second = [r["request_ms"][name][1] for r in runs
                      if r["mode"] == mode]
            line.append(f"{mode} first {statistics.median(first):.3f} ms "
                        f"(of {[round(x, 3) for x in first]}), second "
                        f"{statistics.median(second):.3f}")
        print(f"{name}: " + "; ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
