#!/usr/bin/env python3
"""The reference's joint-training quality over seeds, the yardstick
``chip_smoke.py`` holds the PyTorch port's ``MultiGraphTrainer`` against.

For each seed it runs the JAX reference's Table-7 path at the contract's
config, ``HSDAGConfig(num_devices=2, batch_chains=8, max_episodes=3,
update_timestep=10, seed=s)`` on ``paper_platform()``:

* ``joint``: ``MultiGraphTrainer(cfg).train([inception_v3, resnet50,
  bert_base])``, recording each graph's best latency (seconds);
* ``transfer``: ``MultiGraphTrainer(cfg).train([inception_v3, resnet50])``,
  then ``evaluate_zero_shot(bert_base)``, recording its greedy latency.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_multi_spread.py \
        [--seeds 0-11] [--out piece.json]

Each finished seed is merged into the JSON at once, and a seed already there
is skipped, so a cut run resumes where it stopped.  Pieces run side by side
write files of their own (``--out``); ``--merge A.json B.json ...`` folds
them into ``tools/reference_multi_spread.json``.  It runs on the CPU (about
a minute a seed).  It imports the JAX package; the port does not import it,
and ``chip_smoke.py`` reads only the JSON.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "reference_multi_spread.json")

SEEDS = tuple(range(12))
#: the config of every training run but the seed (``chip_smoke.py`` reads
#: it back)
CONFIG = {"num_devices": 2, "batch_chains": 8, "max_episodes": 3,
          "update_timestep": 10}
#: the joint run's graphs, in ``PAPER_BENCHMARKS`` order
JOINT = ("inception_v3", "resnet50", "bert_base")
#: the transfer run: trained on TRANSFER_FROM, decoding TRANSFER_TO zero-shot
TRANSFER_FROM = ("inception_v3", "resnet50")
TRANSFER_TO = "bert_base"


def _seeds(text: str):
    lo, _, hi = text.partition("-")
    return tuple(range(int(lo), int(hi or lo) + 1))


def load(path: str = OUT) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _save(doc: dict, path: str) -> None:
    doc["seeds"] = sorted(int(s) for s in doc["results"]["transfer"][
        TRANSFER_TO])
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def _empty() -> dict:
    return {"results": {"joint": {n: {} for n in JOINT},
                        "transfer": {TRANSFER_TO: {}}}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=_seeds, default=SEEDS,
                    help="a seed or a range, e.g. 0-11")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--merge", nargs="+", metavar="JSON",
                    help="fold these pieces' results into --out and exit")
    args = ap.parse_args(argv)
    if args.merge:
        doc = load(args.out) or _empty()
        for piece in map(load, args.merge):
            for key in ("config", "platform", "jax_version", "joint",
                        "transfer_from", "transfer_to"):
                doc[key] = piece[key]
            doc["date"] = max(doc.get("date", ""), piece["date"])
            for part, row in piece["results"].items():
                for name, seeds in row.items():
                    doc["results"][part][name].update(seeds)
        _save(doc, args.out)
        return 0

    import jax
    from repro.core import HSDAGConfig, MultiGraphTrainer, paper_platform
    from repro.graphs import PAPER_BENCHMARKS

    doc = load(args.out) or _empty()
    doc.update(config=dict(CONFIG), platform="paper_platform()",
               jax_version=jax.__version__, joint=list(JOINT),
               transfer_from=list(TRANSFER_FROM), transfer_to=TRANSFER_TO)
    plat = paper_platform()
    graphs = {n: PAPER_BENCHMARKS[n]() for n in JOINT}
    for seed in args.seeds:
        if str(seed) in doc["results"]["transfer"][TRANSFER_TO]:
            continue
        cfg = HSDAGConfig(seed=seed, **CONFIG)
        t0 = time.perf_counter()
        res = MultiGraphTrainer(cfg).train([graphs[n] for n in JOINT],
                                           platform=plat)
        for n, lat in zip(JOINT, res.best_latencies):
            doc["results"]["joint"][n][str(seed)] = float(lat)
        t = MultiGraphTrainer(cfg)
        t.train([graphs[n] for n in TRANSFER_FROM], platform=plat)
        _, lat = t.evaluate_zero_shot(graphs[TRANSFER_TO], platform=plat)
        doc["results"]["transfer"][TRANSFER_TO][str(seed)] = float(lat)
        doc["date"] = datetime.date.today().isoformat()
        _save(doc, args.out)
        print(f"seed {seed}: joint best "
              f"{[round(float(x) * 1e3, 6) for x in res.best_latencies]} ms, "
              f"{TRANSFER_TO} zero-shot {lat * 1e3:.6f} ms "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
