#!/usr/bin/env python3
"""The reference's learned baselines over seeds, the yardstick
``chip_smoke.py`` holds the PyTorch port's ``PlacetoBaseline`` and
``RNNBaseline`` against.

For each paper graph and each method it runs the JAX reference's Table-2
path (``benchmarks/common.py``'s ``run_placeto`` / ``run_rnn``) at the
contract's config::

    Method(BaselineConfig(num_devices=2, episodes=3, samples_per_episode=10,
                          seed=s)).search(
        g, extract_features(g, FeatureConfig(d_pos=16)), reward_fn,
        rng=PRNGKey(s))

with the host scheduler's reward (``simulate`` on ``paper_platform()``),
for seeds 0-11, and records each search's best latency (seconds) in
``tools/reference_baseline_spread.json``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_baseline_spread.py \
        [--graph bert_base] [--method rnn] [--seeds 0-11] [--out piece.json]

Each finished search is merged into the JSON at once, and a (graph, method,
seed) already there is skipped, so a cut run resumes where it stopped.
Pieces run side by side write files of their own (``--out``); ``--merge
A.json B.json ...`` folds them into the JSON.  It runs on the CPU; the
reference's RNN compiles its gradient anew for every search, which is most
of a search's time.  It imports the JAX package; the port does not import
it, and ``chip_smoke.py`` reads only the JSON.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "reference_baseline_spread.json")

GRAPHS = ("inception_v3", "resnet50", "bert_base")
METHODS = ("placeto", "rnn")
SEEDS = tuple(range(12))
#: the BaselineConfig of every search but the seed (``chip_smoke.py`` reads
#: it back)
CONFIG = {"num_devices": 2, "episodes": 3, "samples_per_episode": 10}
#: the features both packages extract (``benchmarks/common.py``)
FEATURE = {"d_pos": 16}


def _seeds(text: str):
    lo, _, hi = text.partition("-")
    return tuple(range(int(lo), int(hi or lo) + 1))


def load(path: str = OUT) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _save(doc: dict, path: str) -> None:
    doc["seeds"] = sorted({int(seed) for row in doc["results"].values()
                           for by_seed in row.values() for seed in by_seed})
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", choices=GRAPHS, action="append")
    ap.add_argument("--method", choices=METHODS, action="append")
    ap.add_argument("--seeds", type=_seeds, default=SEEDS,
                    help="a seed or a range, e.g. 0-11")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--merge", nargs="+", metavar="JSON",
                    help="fold these pieces' results into --out and exit")
    args = ap.parse_args(argv)
    if args.merge:
        doc = load(args.out)
        for piece in map(load, args.merge):
            for key in ("config", "feature", "platform", "jax_version"):
                doc[key] = piece[key]
            doc["date"] = max(doc.get("date", ""), piece["date"])
            for name, row in piece["results"].items():
                for method, seeds in row.items():
                    doc.setdefault("results", {}).setdefault(
                        name, {}).setdefault(method, {}).update(seeds)
        _save(doc, args.out)
        return 0

    import jax
    from repro.core import (FeatureConfig, extract_features, paper_platform,
                            simulate)
    from repro.core.baselines import (BaselineConfig, PlacetoBaseline,
                                      RNNBaseline)
    from repro.graphs import PAPER_BENCHMARKS

    methods = {"placeto": PlacetoBaseline, "rnn": RNNBaseline}
    doc = load(args.out)
    doc.setdefault("results", {})
    doc.update(config=dict(CONFIG), feature=dict(FEATURE),
               platform="paper_platform()", jax_version=jax.__version__)
    plat = paper_platform()
    for name in args.graph or GRAPHS:
        g = PAPER_BENCHMARKS[name]()
        arrays = extract_features(g, FeatureConfig(**FEATURE))

        def reward_fn(p, _g=g):
            res = simulate(_g, p, plat)
            return res.reward, res.latency

        for method in args.method or METHODS:
            row = doc["results"].setdefault(name, {}).setdefault(method, {})
            for seed in args.seeds:
                if str(seed) in row:
                    continue
                t0 = time.perf_counter()
                res = methods[method](BaselineConfig(
                    seed=seed, **CONFIG)).search(
                    g, arrays, reward_fn, rng=jax.random.PRNGKey(seed))
                row[str(seed)] = float(res.best_latency)
                doc["date"] = datetime.date.today().isoformat()
                _save(doc, args.out)
                print(f"{name} {method} seed={seed}: best "
                      f"{res.best_latency * 1e3:.6f} ms "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
