"""Compare the cells of dry-run directories, one column group a directory.

    python3 tools/dryrun_compare.py DIR_A DIR_B [DIR_C ...] [--key peak]

reads every traced cell (``<arch>__<shape>__<mesh>.json``, as
``python -m repro_torch.launch.dryrun --all --out DIR`` writes them) of
each directory and prints, cell by cell, each directory's peak bytes, its
temp and argument bytes, and whether its FLOPs, bytes and collective bytes
equal the first directory's; then the cells whose peak differs from the
first directory's, with the ratio, largest first, and a count of the cells
whose FLOPs, bytes or collectives differ.  Cells missing from a directory
are named.
"""
from __future__ import annotations

import json
import os
import sys


def load(path):
    cells = {}
    for name in sorted(os.listdir(path)):
        if not name.endswith(".json") or "__skip" in name \
                or "__" not in name:
            continue
        with open(os.path.join(path, name)) as f:
            rec = json.load(f)
        if rec.get("skipped"):
            continue
        cells[name[:-len(".json")]] = rec
    return cells


def _counts(rec):
    return (rec["flops"], rec["bytes_accessed"],
            rec["collectives"]["total"])


def main(argv) -> int:
    dirs = [a for a in argv if not a.startswith("--")]
    if len(dirs) < 2:
        print(__doc__)
        return 2
    runs = [load(d) for d in dirs]
    names = sorted(set().union(*runs))
    print("cell | " + " | ".join(
        f"{os.path.basename(os.path.normpath(d))}: peak B, temp B, args B, "
        f"counts as the first" for d in dirs))
    differ = []
    counts_differ = {d: [] for d in dirs[1:]}
    for name in names:
        row = []
        base = runs[0].get(name)
        for d, run in zip(dirs, runs):
            rec = run.get(name)
            if rec is None:
                row.append("missing")
                continue
            mem = rec["memory"]
            same = base is not None and _counts(rec) == _counts(base)
            row.append(f"{mem['peak_bytes']} {mem['temp_size_in_bytes']} "
                       f"{mem['argument_size_in_bytes']} {same}")
            if base is not None and rec is not base:
                if mem["peak_bytes"] != base["memory"]["peak_bytes"]:
                    differ.append((mem["peak_bytes"]
                                   / base["memory"]["peak_bytes"], name, d))
                if not same:
                    counts_differ[d].append(name)
        print(f"{name} | " + " | ".join(row))
    print(f"\n{len(names)} cells; peaks that differ from "
          f"{dirs[0]}: {len(differ)}")
    for ratio, name, d in sorted(differ, reverse=True):
        print(f"  {name} in {d}: {ratio:.4f}x")
    for d, bad in counts_differ.items():
        print(f"cells whose FLOPs, bytes or collectives differ from "
              f"{dirs[0]} in {d}: {len(bad)} {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
