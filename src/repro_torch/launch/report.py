"""Render dry-run + roofline results into a subsection of PERF.md.

Port of ``repro/launch/report.py``:

    PYTHONPATH=src python -m repro_torch.launch.report --dir results/dryrun

Replaces the <!-- DRYRUN_TABLE --> and <!-- ROOFLINE_TABLE --> markers
(idempotent: regenerates between marker and the next section header).
The roofline table is computed from ``launch/roofline.HW`` (256 H100 SXM
80 GB), not measured.
"""
from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List

from .roofline import analyze_dir

__all__ = ["main", "load_cells", "dryrun_table", "roofline_table"]


def _fmt_gb(x) -> str:
    return f"{x/1e9:.2f}" if x is not None else "—"


def load_cells(dry_dir: str) -> List[Dict]:
    cells = []
    for name in sorted(os.listdir(dry_dir)):
        if name.endswith(".json") and "__" in name:
            with open(os.path.join(dry_dir, name)) as f:
                d = json.load(f)
            d["_file"] = name
            cells.append(d)
    return cells


def dryrun_table(cells: List[Dict]) -> str:
    rows = ["| arch | shape | mesh | trace (s) | temp GB/dev | args GB/dev "
            "| TFLOP/dev | coll GB/dev | note |",
            "|---|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if "__skip" in d.get("_file", ""):
            rows.append(f"| {d['arch']} | {d['shape']} | — | — | — | — | — "
                        f"| — | skipped: {d['skipped'][:60]}… |")
            continue
        if d.get("skipped"):
            continue
        m = d.get("memory") or {}
        flops = d.get("flops")
        coll = (d.get("collectives") or {}).get("total")
        compile_s = d.get("compile_scanned_s", 0)
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | {compile_s:.0f} | "
            f"{_fmt_gb(m.get('temp_size_in_bytes'))} | "
            f"{_fmt_gb(m.get('argument_size_in_bytes'))} | "
            f"{(flops or 0)/1e12:.2f} | {_fmt_gb(coll)} | "
            f"{d.get('cost_source', '')[:24]} |")
    return "\n".join(rows)


def roofline_table(dry_dir: str, mesh: str = "32x8") -> str:
    rows = analyze_dir(dry_dir, mesh=mesh)
    out = ["| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
           "dominant | useful | roofline % | what would move it |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']*1e3:.2f} | "
            f"{r['memory_s']*1e3:.2f} | {r['collective_s']*1e3:.2f} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{100*r['roofline_fraction']:.1f} | {r['note'][:60]}… |")
    return "\n".join(out)


def _splice(text: str, marker: str, table: str) -> str:
    pattern = re.compile(
        rf"({re.escape(marker)}\n)(.*?)(\n## |\n### |\n<!-- |\Z)", re.S)

    def repl(m):
        return m.group(1) + "\n" + table + "\n" + m.group(3)

    return pattern.sub(repl, text, count=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--perf", default="PERF.md")
    ap.add_argument("--mesh", default="32x8")
    args = ap.parse_args(argv)
    cells = [c for c in load_cells(args.dir)
             if c.get("mesh", args.mesh) == args.mesh or c.get("skipped")]
    with open(args.perf) as f:
        text = f.read()
    text = _splice(text, "<!-- DRYRUN_TABLE -->", dryrun_table(cells))
    text = _splice(text, "<!-- ROOFLINE_TABLE -->",
                   roofline_table(args.dir, args.mesh))
    with open(args.perf, "w") as f:
        f.write(text)
    n = sum(1 for c in cells if not c.get("skipped"))
    print(f"updated {args.perf}: {n} traced cells, "
          f"{len(cells)-n} documented skips")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
