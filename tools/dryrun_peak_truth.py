"""Hold the dry run's peak against what rank 0 allocates on the card.

    python3 tools/dryrun_peak_truth.py [--cell ARCH:SHAPE[:multi][:LAYERS]]...
        [--out results/dryrun_peak_truth.jsonl]

runs each cell (default :data:`CELLS`) in a process of its own, twice on
the production mesh of a ``"fake"`` process group (this process its rank
0), at full width and at full depth or the depth LAYERS names:

* ``fake``: ``launch.dryrun.run_cell`` as the CLI runs it, on fake CPU
  tensors;
* ``cuda``: the same step on real CUDA tensors (``real=True,
  device="cuda"``): rank 0's shards of random weights, the kernels
  launched, the collectives allocating their outputs but moving no data,
  ``max_memory_allocated`` over the step.

Each run also reads ``torch.distributed._tools.mem_tracker.MemTracker``'s
peak, the dry run's tracker before ``launch/dryrun.memory_tracker``, fed
the placed arguments as the dry run fed it.  One JSON line a run, with the
card's name and power limit and the torch version; ``--child`` is the
per-cell process.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

#: (arch, shape, multi-pod, layers or None for full depth): the four
#: single-pod cells whose peak torch 2.11's MemTracker put farthest above
#: 2.13's (the parent tree's ``--all``), a train cell, and the decode cell
#: whose cache slots split over "model"; each fits one card at full depth
CELLS = (("qwen1.5-0.5b", "prefill_32k", False, None),
         ("phi3-mini-3.8b", "prefill_32k", False, None),
         ("qwen1.5-0.5b", "decode_32k", False, None),
         ("phi3-mini-3.8b", "decode_32k", False, None),
         ("h2o-danube-1.8b", "train_4k", False, None),
         ("h2o-danube-1.8b", "decode_32k", False, None))


def _parse(text):
    parts = text.split(":")
    multi = "multi" in parts[2:]
    layers = next((int(p) for p in parts[2:] if p.isdigit()), None)
    return parts[0], parts[1], multi, layers


def _gpu():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def child(arch, shape, multi, layers, device="cuda") -> int:
    sys.path.insert(0, SRC)
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch import dryrun
    tracker = dryrun.memory_tracker
    seen = {}

    def both(fake_mode=None):
        # the dry run's tracker, with MemTracker fed the same arguments
        mine, old = tracker(fake_mode), MemTracker()

        class _Both:
            peak = property(lambda self: mine.peak)

            def track(self, ts):
                mine.track(ts)
                old.track_external(*ts)

            def __enter__(self):
                old.__enter__()
                mine.__enter__()
                return self

            def __exit__(self, *exc):
                mine.__exit__(*exc)
                old.__exit__(*exc)
                snap = old.get_tracker_snapshot("peak")
                seen["memtracker_peak"] = max(
                    (v.get("Total", 0) for v in snap.values()), default=0)
        return _Both()
    dryrun.memory_tracker = both
    over = {"n_layers": layers} if layers else None
    if device == "cuda":
        torch.cuda.set_device(0)
    for route in ("cuda", "fake"):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod=multi,
                              config_overrides=over, real=route == "cuda",
                              device=device)
        mem = rec["memory"]
        print(json.dumps({
            "arch": arch, "shape": shape, "mesh": rec["mesh"],
            "layers": layers, "route": route,
            "peak_bytes": mem["peak_bytes"],
            "argument_size_in_bytes": mem["argument_size_in_bytes"],
            "max_memory_allocated": mem.get("max_memory_allocated"),
            "memtracker_peak": seen.pop("memtracker_peak"),
            # the aten ops' own counts: on the card the kernels launch and
            # add no work, so these are what the two routes share
            "aten_flops": rec["aten_flops"], "aten_bytes": rec["aten_bytes"],
            "collectives": rec["collectives"]["total"],
            "seconds": round(time.perf_counter() - t0, 2),
            "torch": torch.__version__,
            "device": torch.cuda.get_device_name(0) if device == "cuda"
            else device}), flush=True)
        if device == "cuda":
            # give the cached blocks back: cells run side by side
            torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="append", default=[])
    ap.add_argument("--out", default="results/dryrun_peak_truth.jsonl")
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    ap.add_argument("--child", default=None)
    ap.add_argument("--device", default="cuda",
                    help="a child's device (cpu rehearses a cut cell)")
    args = ap.parse_args(argv)
    if args.child:
        return child(*_parse(args.child), device=args.device)
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels._build import build_all
    print(f"gpu: {_gpu()}; torch {torch.__version__}; kernels built in "
          f"{build_all()} s", flush=True)
    cells = [_parse(c) for c in args.cell] or list(CELLS)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    failed = 0
    env = dict(os.environ, PYTHONPATH=SRC)

    def run(cell):
        arch, shape, multi, layers = cell
        name = ":".join([arch, shape] + (["multi"] if multi else [])
                        + ([str(layers)] if layers else []))
        return name, subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", name],
            env=env, capture_output=True, text=True, timeout=args.timeout)
    from concurrent.futures import ThreadPoolExecutor
    with open(args.out, "a") as f, \
            ThreadPoolExecutor(args.jobs) as pool:
        for name, proc in pool.map(run, cells):
            lines = [x for x in proc.stdout.splitlines()
                     if x.startswith("{")]
            for line in lines:
                rec = dict(json.loads(line), gpu=_gpu())
                f.write(json.dumps(rec) + "\n")
                ratio = (rec["max_memory_allocated"] / rec["peak_bytes"]
                         if rec["max_memory_allocated"] else None)
                print(f"{name} {rec['route']}: peak {rec['peak_bytes']} B, "
                      f"MemTracker {rec['memtracker_peak']} B, "
                      f"max_memory_allocated {rec['max_memory_allocated']} "
                      f"B (÷ peak {ratio}), args "
                      f"{rec['argument_size_in_bytes']} B, "
                      f"{rec['seconds']} s", flush=True)
            if proc.returncode != 0:
                failed += 1
                print(f"FAIL {name} rc {proc.returncode}:\n"
                      f"{proc.stderr[-3000:]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
