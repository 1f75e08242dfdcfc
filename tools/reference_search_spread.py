#!/usr/bin/env python3
"""The reference's search quality over seeds, the yardstick ``chip_smoke.py``
holds the PyTorch port's search against.

For each paper graph and each engine it runs the JAX reference's

    HSDAG(HSDAGConfig(batch_chains=16, max_episodes=3, seed=s)).search(
        g, extract_features(g), platform=paper_platform(), engine=...)

for seeds 0-11 and records each search's best latency (seconds) in
``tools/reference_search_spread.json``, beside the config, the JAX version
and the date.  The engines are the default (``"auto"``: the in-rollout
``scan`` reward) and ``"level"``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_search_spread.py \
        [--graph inception_v3] [--engine level] [--seeds 0-11]

Each finished search is merged into the JSON at once, and a (graph, engine,
seed) already there is skipped, so a cut run resumes where it stopped and
pieces can run one after another.  Pieces run side by side write files of
their own (``--out``); ``--merge A.json B.json ...`` folds them into the
JSON.  Each search's episodes (mean groups, mean reward, best latency so
far) go under ``history`` beside its result.
``tools/reference_search_spread_extra.json`` holds seeds 12-35 of the
default engine on ResNet-50 and seeds 0-35 of both engines on BERT-base,
with their episodes, written so, for a closer look at those pairs
(``tools/port_search_spread.py --ref``).  It runs on the CPU (a few tens of
seconds a search on Inception-v3).  ``--save-init DIR`` writes, instead of
searching, the initial weights each search starts from as reference policy
checkpoints (``DIR/<graph>/seed_<s>``), which ``tools/port_search_spread.py
--init-from DIR`` starts the port's searches from.
It imports the JAX package; the port does not import it.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "reference_search_spread.json")

GRAPHS = ("inception_v3", "resnet50", "bert_base")
ENGINES = ("auto", "level")
SEEDS = tuple(range(12))
#: the config of every search, but the seed (``chip_smoke.py`` reads it back)
CONFIG = {"batch_chains": 16, "max_episodes": 3}
#: what ``history`` keeps of each episode
EPISODE_KEYS = ("mean_groups", "mean_reward", "best_latency")


def episodes(history) -> list:
    """A search's history → one ``EPISODE_KEYS`` row an episode."""
    return [[float(h[k]) for k in EPISODE_KEYS] for h in history]


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


def save_init(directory: str, graphs, seeds) -> None:
    """The weights the reference's batched search starts from — its
    ``init`` on the first split of ``PRNGKey(seed)`` — as policy
    checkpoints under ``directory/<graph>/seed_<s>``."""
    import jax
    from repro.checkpoint import save_policy
    from repro.core import HSDAG, HSDAGConfig, extract_features
    from repro.graphs import PAPER_BENCHMARKS
    for name in graphs:
        arrays = extract_features(PAPER_BENCHMARKS[name]())
        for seed in seeds:
            agent = HSDAG(HSDAGConfig(seed=seed, **CONFIG))
            _, k_init = jax.random.split(jax.random.PRNGKey(seed))
            params = agent.init(k_init, arrays)
            save_policy(os.path.join(directory, name, f"seed_{seed}"),
                        params, meta={"config": agent.cfg.to_json()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", choices=GRAPHS, action="append")
    ap.add_argument("--engine", choices=ENGINES, action="append")
    ap.add_argument("--seeds", type=_seeds, default=SEEDS,
                    help="a seed or a range, e.g. 0-11")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--merge", nargs="+", metavar="JSON",
                    help="fold these pieces' results into --out and exit")
    ap.add_argument("--save-init", metavar="DIR",
                    help="write each search's initial weights here and exit")
    args = ap.parse_args(argv)
    if args.merge:
        doc = load(args.out)
        for piece in map(load, args.merge):
            for key in ("config", "platform", "jax_version"):
                doc[key] = piece[key]
            doc["date"] = max(doc.get("date", ""), piece["date"])
            for part in ("results", "history"):
                for name, row in piece.get(part, {}).items():
                    for engine, seeds in row.items():
                        doc.setdefault(part, {}).setdefault(
                            name, {}).setdefault(engine, {}).update(seeds)
        _save(doc, args.out)
        return 0

    import jax
    from repro.core import (HSDAG, HSDAGConfig, extract_features,
                            paper_platform)
    from repro.graphs import PAPER_BENCHMARKS
    if args.save_init:
        save_init(args.save_init, args.graph or GRAPHS, args.seeds)
        return 0

    doc = load(args.out)
    doc.setdefault("results", {})
    doc["config"] = dict(CONFIG)
    doc["platform"] = "paper_platform()"
    doc["jax_version"] = jax.__version__
    plat = paper_platform()
    for name in args.graph or GRAPHS:
        g = PAPER_BENCHMARKS[name]()
        arrays = extract_features(g)
        for engine in args.engine or ENGINES:
            row = doc["results"].setdefault(name, {}).setdefault(engine, {})
            for seed in args.seeds:
                if str(seed) in row:
                    continue
                agent = HSDAG(HSDAGConfig(seed=seed, **CONFIG))
                t0 = time.perf_counter()
                res = agent.search(g, arrays, platform=plat, engine=engine)
                row[str(seed)] = float(res.best_latency)
                doc.setdefault("history", {}).setdefault(name, {}).setdefault(
                    engine, {})[str(seed)] = episodes(res.history)
                doc["date"] = datetime.date.today().isoformat()
                _save(doc, args.out)
                print(f"{name} engine={engine} seed={seed}: best "
                      f"{res.best_latency * 1e3:.6f} ms "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
