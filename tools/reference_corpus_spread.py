#!/usr/bin/env python3
"""The reference's corpus-training quality over seeds, the yardstick
``chip_smoke.py`` holds the PyTorch port's ``CurriculumTrainer`` against.

For each seed it runs the JAX reference's Table-8 path
(``benchmarks/table8_corpus.py``) at the contract's config on
``paper_platform()``, over Table 8's corpus less its ``traced`` entry::

    CurriculumTrainer(HSDAGConfig(num_devices=2, batch_chains=8,
                                  max_episodes=3, update_timestep=10,
                                  seed=s),
                      max_buckets=3, graphs_per_episode=4)
        .train_corpus(corpus, platform=paper_platform())   # rng=PRNGKey(s)

and records

* ``greedy``: each corpus graph's greedy latency after training (seconds);
* ``best``: the best sampled latency of Inception-v3 and ResNet-50, the two
  graphs whose one-graph buckets every stratified cycle samples;
* ``zero_shot``: ``evaluate_zero_shot`` of the two held-out ``branch_join``
  graphs;
* ``sequence``: each episode's (bucket, graph ids), which the port's
  sampler must draw too.

The JSON also keeps the corpus's graph names and sizes, its bucket
partition and its ``corpus_fingerprint``, which the card (no JAX there)
checks the port's corpus against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_corpus_spread.py \
        [--full] [--seeds 0-11] [--out piece.json]

``--full`` runs Table 8's full corpus, its ``traced`` entry included, into
``tools/reference_corpus_spread_full.json`` (the merge target too); without
it the corpus is the one above and the JSON
``tools/reference_corpus_spread.json``.

Each finished seed is merged into the JSON at once, and a seed already there
is skipped, so a cut run resumes where it stopped.  Pieces run side by side
write files of their own (``--out``); ``--merge A.json B.json ...`` folds
them into the JSON.  It runs on the CPU (about
45 s a seed).  It imports the JAX package; the port does not import it, and
``chip_smoke.py`` reads only the JSON.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "reference_corpus_spread.json")

SEEDS = tuple(range(12))
#: Table 8's corpus without its ``traced`` entry (``table8_corpus.py``)
CORPUS = ("benchmark:names=inception_v3+resnet50;"
          "lm:archs=qwen1.5-0.5b+mamba2-130m:seq_len=1024;"
          "synthetic:family=layered+series_parallel:count=6:size=40:seed=0")
#: Table 8's full corpus (``--full``), its ``traced`` entry included
FULL_CORPUS = ("benchmark:names=inception_v3+resnet50;"
               "traced:archs=qwen1.5-0.5b+phi3-mini-3.8b;"
               "lm:archs=qwen1.5-0.5b+mamba2-130m:seq_len=1024;"
               "synthetic:family=layered+series_parallel:count=6:size=40:"
               "seed=0")
FULL_OUT = os.path.join(HERE, "reference_corpus_spread_full.json")
#: Table 8's held-out family
HELD_OUT = "synthetic:family=branch_join:count=2:size=40:seed=123"
#: the HSDAGConfig of every run but the seed (``chip_smoke.py`` reads it)
CONFIG = {"num_devices": 2, "batch_chains": 8, "max_episodes": 3,
          "update_timestep": 10}
#: the CurriculumTrainer's arguments
TRAINER = {"max_buckets": 3, "graphs_per_episode": 4}
#: the graphs whose best latency is recorded
BEST = ("inception_v3", "resnet50")


def _seeds(text: str):
    lo, _, hi = text.partition("-")
    return tuple(range(int(lo), int(hi or lo) + 1))


def load(path: str = OUT) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _save(doc: dict, path: str) -> None:
    doc["seeds"] = sorted(int(s) for s in doc["results"]["sequence"])
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def _empty() -> dict:
    return {"results": {"greedy": {}, "best": {}, "zero_shot": {},
                        "sequence": {}}}


_STATIC = ("config", "trainer", "platform", "jax_version", "corpus",
           "held_out", "graphs", "num_nodes", "buckets", "fingerprint",
           "held_out_graphs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=_seeds, default=SEEDS,
                    help="a seed or a range, e.g. 0-11")
    ap.add_argument("--full", action="store_true",
                    help="Table 8's full corpus, its traced entry included "
                         "(default --out tools/reference_corpus_spread_"
                         "full.json)")
    ap.add_argument("--out")
    ap.add_argument("--merge", nargs="+", metavar="JSON",
                    help="fold these pieces' results into --out and exit")
    args = ap.parse_args(argv)
    args.out = args.out or (FULL_OUT if args.full else OUT)
    spec = FULL_CORPUS if args.full else CORPUS
    if args.merge:
        doc = load(args.out) or _empty()
        for piece in map(load, args.merge):
            for key in _STATIC:
                doc[key] = piece[key]
            doc["date"] = max(doc.get("date", ""), piece["date"])
            for part, row in piece["results"].items():
                if part == "sequence":
                    doc["results"][part].update(row)
                    continue
                for name, seeds in row.items():
                    doc["results"][part].setdefault(name, {}).update(seeds)
        _save(doc, args.out)
        return 0

    import jax
    from repro.core import HSDAGConfig, paper_platform, plan_buckets
    from repro.core.train import CurriculumTrainer
    from repro.graphs import build_corpus, corpus_fingerprint

    plat = paper_platform()
    corpus = build_corpus(spec)
    held = build_corpus(HELD_OUT)
    names = [g.name for g in corpus]
    sizes = [g.num_nodes for g in corpus]
    doc = load(args.out) or _empty()
    doc.update(config=dict(CONFIG), trainer=dict(TRAINER),
               platform="paper_platform()", jax_version=jax.__version__,
               corpus=spec, held_out=HELD_OUT, graphs=names,
               num_nodes=sizes,
               buckets=plan_buckets(sizes, TRAINER["max_buckets"]),
               fingerprint=corpus_fingerprint(corpus),
               held_out_graphs=[g.name for g in held])
    res_doc = doc["results"]
    for seed in args.seeds:
        if str(seed) in res_doc["sequence"]:
            continue
        cfg = HSDAGConfig(seed=seed, **CONFIG)
        t0 = time.perf_counter()
        trainer = CurriculumTrainer(cfg, **TRAINER)
        res = trainer.train_corpus(corpus, platform=plat)
        for n, lat in zip(names, res.greedy_latencies):
            res_doc["greedy"].setdefault(n, {})[str(seed)] = float(lat)
        for n in BEST:
            res_doc["best"].setdefault(n, {})[str(seed)] = float(
                res.best_latencies[names.index(n)])
        for g in held:
            _, lat = trainer.evaluate_zero_shot(g, platform=plat)
            res_doc["zero_shot"].setdefault(g.name, {})[str(seed)] = \
                float(lat)
        res_doc["sequence"][str(seed)] = [
            [int(h["bucket"]), [names.index(n) for n in h["graphs"]]]
            for h in res.history]
        doc["date"] = datetime.date.today().isoformat()
        _save(doc, args.out)
        print(f"seed {seed}: greedy "
              f"{[round(float(x) * 1e3, 6) for x in res.greedy_latencies]}"
              f" ms ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
