#!/usr/bin/env python3
"""The reference's Table-13 yardsticks, which ``chip_smoke.py``'s topology
phase and its device-head contract hold the PyTorch port against.

It runs the JAX reference's device-head search of Table 13
(``benchmarks/table13_topology.py``) on its workload,
``series_parallel_dag(target_nodes=20, seed=0)`` featurized with
``FeatureConfig(d_pos=16)``:

    HSDAG(HSDAGConfig(num_devices=4, head="device", max_episodes=12,
                      update_timestep=10, batch_chains=8, seed=s)).search(
        g, arrays, platform=fleet)

for seeds 0-11 on ``nvlink_island(2, 2)`` and ``torus(2, 2)``, and records
each search's best latency (seconds, as the search scored it in float32)
under ``results`` and the host scheduler's float64 latency of its best
placement (``simulate``) under ``host_latency`` in
``tools/reference_topology_spread.json``, with the exact DP bound
(``dp_optimal(g, fleet).bound``) of all four Table-13 fleets, the config,
the JAX version and the date.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_topology_spread.py \
        [--fleet torus] [--seeds 0-11] [--out piece.json]

Each finished search is merged into the JSON at once and a (fleet, seed)
already there is skipped, so a cut run resumes; pieces run side by side
write files of their own (``--out``) and ``--merge A.json B.json ...`` folds
them in.  The searches of this small graph tie often (several seeds find
the same placement), so the contract compares ``host_latency``: the same
placement gives the same float64 number in both packages, where float32
scores computed in another order could differ in the last bit.  A search
takes a few seconds on the CPU.  It imports the JAX
package; the port does not import it.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "reference_topology_spread.json")

#: Table 13's fleets (``benchmarks/table13_topology.py``), by builder call
FLEETS = {
    "nvlink_island": ("nvlink_island", {"islands": 2, "gpus_per_island": 2}),
    "multi_host": ("multi_host", {"hosts": 2, "gpus_per_host": 2}),
    "torus": ("torus", {"rows": 2, "cols": 2}),
    "ring": ("ring", {"devices": 4}),
}
#: the fleets whose device-head search spread is recorded
SEARCHED = ("nvlink_island", "torus")
SEEDS = tuple(range(12))
#: the workload, its features, and every search's config but the seed
#: (``chip_smoke.py`` reads them back)
GRAPH = {"family": "series_parallel", "target_nodes": 20, "seed": 0}
FEATURES = {"d_pos": 16}
CONFIG = {"num_devices": 4, "head": "device", "max_episodes": 12,
          "update_timestep": 10, "batch_chains": 8}


def _seeds(text: str):
    lo, _, hi = text.partition("-")
    return tuple(range(int(lo), int(hi or lo) + 1))


def load(path: str = OUT) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _save(doc: dict, path: str) -> None:
    doc["seeds"] = sorted({int(s) for row in doc["results"].values()
                           for s in row})
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fleet", choices=SEARCHED, action="append")
    ap.add_argument("--seeds", type=_seeds, default=SEEDS,
                    help="a seed or a range, e.g. 0-11")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--merge", nargs="+", metavar="JSON",
                    help="fold these pieces' results into --out and exit")
    args = ap.parse_args(argv)
    if args.merge:
        doc = load(args.out)
        for piece in map(load, args.merge):
            for key in ("config", "graph", "features", "fleets", "dp_bound",
                        "jax_version"):
                doc[key] = piece[key]
            doc["date"] = max(doc.get("date", ""), piece["date"])
            for part in ("results", "host_latency"):
                for fleet, row in piece[part].items():
                    doc.setdefault(part, {}).setdefault(fleet, {}).update(
                        row)
        _save(doc, args.out)
        return 0

    import jax
    from repro import platforms
    from repro.core import (HSDAG, FeatureConfig, HSDAGConfig,
                            extract_features, simulate)
    from repro.graphs.synthetic import series_parallel_dag

    g = series_parallel_dag(target_nodes=GRAPH["target_nodes"],
                            seed=GRAPH["seed"])
    arrays = extract_features(g, FeatureConfig(**FEATURES))
    fleets = {name: getattr(platforms, fn)(**kw)
              for name, (fn, kw) in FLEETS.items()}
    doc = load(args.out)
    doc.setdefault("results", {})
    doc.setdefault("host_latency", {})
    doc["config"] = dict(CONFIG)
    doc["graph"] = dict(GRAPH)
    doc["features"] = dict(FEATURES)
    doc["fleets"] = {name: {"builder": fn, "args": kw}
                     for name, (fn, kw) in FLEETS.items()}
    doc["dp_bound"] = {name: float(platforms.dp_optimal(g, plat).bound)
                       for name, plat in fleets.items()}
    doc["jax_version"] = jax.__version__
    doc["date"] = datetime.date.today().isoformat()
    for name in args.fleet or SEARCHED:
        row = doc["results"].setdefault(name, {})
        for seed in args.seeds:
            if str(seed) in row:
                continue
            t0 = time.perf_counter()
            res = HSDAG(HSDAGConfig(seed=seed, **CONFIG)).search(
                g, arrays, platform=fleets[name])
            row[str(seed)] = float(res.best_latency)
            doc["host_latency"].setdefault(name, {})[str(seed)] = float(
                simulate(g, res.best_placement, fleets[name]).latency)
            doc["date"] = datetime.date.today().isoformat()
            _save(doc, args.out)
            print(f"{name} seed={seed}: best {res.best_latency * 1e6:.6f} us "
                  f"(bound {doc['dp_bound'][name] * 1e6:.6f} us; "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)
    _save(doc, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
