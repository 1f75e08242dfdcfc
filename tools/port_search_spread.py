#!/usr/bin/env python3
"""The PyTorch port's search quality over seeds, on the card, beside the
reference's.

For each graph and engine given it runs the port's

    HSDAG(HSDAGConfig(batch_chains=16, max_episodes=3, seed=s)).search(
        g, extract_features(g), platform=paper_platform(), engine=...)

for the seeds given, prints each best latency, and — for the seeds the
reference JSONs hold (``tools/reference_search_spread.json`` and any
``--ref`` pieces written by ``tools/reference_search_spread.py --out``) —
both sides' medians and the one-sided Mann-Whitney p-value that the port's
latencies are larger.  Where the reference's pieces hold the searches'
episodes too, it sets each episode's mean groups, mean reward and best
latency so far beside the reference's (medians and a two-sided
Mann-Whitney p-value over the shared seeds; the first window's mean groups
seed by seed), and prints each seed's episodes on both sides.
``chip_smoke.py`` runs the same comparison over seeds 0-11; this tool takes
more seeds where a pair needs a closer look.

The port's search for a seed starts from the reference's initial weights
for that seed (``HSDAG.init`` draws the reference's threefry stream), so the
two sides differ only in their random draws; the tool also prints the
paired (Wilcoxon signed-rank, two-sided) p-value of the best latencies,
seed by seed.

``--from-json RUN.json ...`` reports on earlier runs' ``--out`` files
instead of searching (no card needed), over the seeds given; with several
runs it also prints the range of the p-value over every combination of the
per-seed latencies the runs hold, which bounds what the card's run-to-run
variation does to the comparison.

    python3 tools/port_search_spread.py --graph bert_base --engine auto \\
        --seeds 0-35 --ref tools/reference_search_spread_extra.json \\
        [--out chiprun_out/port_spread.json]

Imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

from reference_search_spread import (CONFIG, ENGINES, EPISODE_KEYS,  # noqa: E402,E501
                                     GRAPHS, OUT, _seeds, episodes, load)


def _merged(docs, part: str, name: str, engine: str) -> dict:
    out = {}
    for doc in docs:
        out.update(doc.get(part, {}).get(name, {}).get(engine, {}))
    return out


def compare(name: str, engine: str, port: dict, port_hist: dict, ref: dict,
            ref_hist: dict, *, paired: bool, note: str = "") -> None:
    """Print the port's latencies beside the reference's over the shared
    seeds, then the episodes' statistics (see the module docstring)."""
    from scipy.stats import mannwhitneyu, wilcoxon
    shared = sorted(set(port) & set(ref), key=int)
    line = f"{name} engine={engine}: {len(port)} port searches{note}"
    if shared:
        a = np.array([port[k] for k in shared])
        b = np.array([ref[k] for k in shared])
        p = float(mannwhitneyu(a, b, alternative="greater").pvalue)
        line += (f"; over the {len(shared)} seeds both sides have: "
                 f"port median {np.median(a) * 1e3:.6f} ms, "
                 f"reference median {np.median(b) * 1e3:.6f} ms, "
                 f"Mann-Whitney p(port worse) = {p:.4g}")
        if paired and np.any(a != b):
            line += f"; paired Wilcoxon p = {float(wilcoxon(a, b).pvalue):.4g}"
    print(line)
    print(f"  port ms: "
          f"{[round(port[k] * 1e3, 6) for k in sorted(port, key=int)]}")
    shared = sorted(set(port_hist) & set(ref_hist), key=int)
    if not shared:
        return
    a = np.array([port_hist[k] for k in shared])     # (seeds, episodes, 3)
    b = np.array([ref_hist[k] for k in shared])
    for ep in range(a.shape[1]):
        for i, key in enumerate(EPISODE_KEYS):
            p = float(mannwhitneyu(a[:, ep, i], b[:, ep, i],
                                   alternative="two-sided").pvalue)
            print(f"  episode {ep} {key}: port median "
                  f"{np.median(a[:, ep, i]):.6g}, reference median "
                  f"{np.median(b[:, ep, i]):.6g}, two-sided p = {p:.4g} "
                  f"({len(shared)} seeds)")
    rel = np.abs(a[:, 0, 0] - b[:, 0, 0]) / b[:, 0, 0]
    print(f"  first window's mean groups, seed by seed: |port - reference| "
          f"/ reference median {np.median(rel):.4g}, max {rel.max():.4g}")
    for k, pa, pb in zip(shared, a, b):
        print(f"  seed {k}: port {_episodes_text(pa)}; reference "
              f"{_episodes_text(pb)}")


def _episodes_text(rows) -> str:
    return " | ".join(f"{g:.2f} / {r:.4f} / {t * 1e3:.6f}"
                      for g, r, t in rows)


def p_range(runs, ref: dict) -> str:
    """The one-sided p-value's range over every combination of the
    per-seed latencies that ``runs`` (dicts seed → latency) hold."""
    from scipy.stats import mannwhitneyu
    shared = sorted(set.intersection(*(set(r) for r in runs)) & set(ref),
                    key=int)
    b = np.array([ref[k] for k in shared])
    seen = [sorted({r[k] for r in runs}) for k in shared]
    ps = [float(mannwhitneyu(np.array(a), b, alternative="greater").pvalue)
          for a in itertools.product(*seen)]
    return (f"over the {len(ps)} combinations of the {len(runs)} runs' "
            f"per-seed latencies ({len(shared)} seeds): p from "
            f"{min(ps):.4g} to {max(ps):.4g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", choices=GRAPHS, action="append")
    ap.add_argument("--engine", choices=ENGINES, action="append")
    ap.add_argument("--seeds", type=_seeds, default=tuple(range(12)))
    ap.add_argument("--ref", action="append", default=[],
                    help="more reference results (JSON pieces)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="write the port's latencies here")
    ap.add_argument("--from-json", nargs="+", metavar="RUN",
                    help="report on these earlier --out files; no search")
    args = ap.parse_args(argv)
    ref_docs = [load(OUT)] + [load(p) for p in args.ref]
    keep = {str(s) for s in args.seeds}

    if args.from_json:
        runs = [load(p) for p in args.from_json]
        for name in args.graph or GRAPHS:
            for engine in args.engine or ENGINES:
                ref = _merged(ref_docs, "results", name, engine)
                ref_hist = _merged(ref_docs, "history", name, engine)
                ports = []
                for path, run in zip(args.from_json, runs):
                    port = {k: v for k, v in _merged(
                        [run], "results", name, engine).items() if k in keep}
                    hist = {k: v for k, v in _merged(
                        [run], "history", name, engine).items() if k in keep}
                    ports.append(port)
                    compare(name, engine, port, hist, ref, ref_hist,
                            paired=run.get("paired", False),
                            note=f" ({os.path.basename(path)})")
                if len(ports) > 1:
                    print(f"{name} engine={engine}: {p_range(ports, ref)}")
        return 0

    import torch
    from repro_torch import (HSDAG, HSDAGConfig, PAPER_BENCHMARKS,
                             extract_features, paper_platform)
    torch.backends.cuda.matmul.allow_tf32 = False

    plat = paper_platform()
    out = {"config": CONFIG, "paired": True, "results": {}, "history": {}}
    for name in args.graph or GRAPHS:
        g = PAPER_BENCHMARKS[name]()
        arrays = extract_features(g)
        for engine in args.engine or ENGINES:
            port, port_hist = {}, {}
            t0 = time.perf_counter()
            for s in args.seeds:
                agent = HSDAG(HSDAGConfig(seed=s, **CONFIG),
                              device=args.device)
                res = agent.search(g, arrays, platform=plat, engine=engine)
                port[str(s)] = float(res.best_latency)
                port_hist[str(s)] = episodes(res.history)
            out["results"].setdefault(name, {})[engine] = port
            out["history"].setdefault(name, {})[engine] = port_hist
            compare(name, engine, port, port_hist,
                    _merged(ref_docs, "results", name, engine),
                    _merged(ref_docs, "history", name, engine),
                    paired=True,
                    note=f" in {time.perf_counter() - t0:.2f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
