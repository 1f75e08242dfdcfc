"""Roofline analysis of the dry run's cells, with H100 constants.

Port of ``repro/launch/roofline.py``.  Three terms per (arch × shape)
cell, from the dry run's per-device counts:

    compute    = FLOPs       / 989e12 FLOP/s bf16 dense (tensor cores)
    memory     = bytes       / 3.35e12 B/s HBM3
    collective = Σ_axis coll_bytes(axis) / link(axis)

The reference divides all collective bytes by one ICI rate.  On the card
each mesh axis crosses its own link: "model" stays inside an 8-GPU node on
NVLink, "data" and "pod" cross nodes on InfiniBand.  So the collective term
sums each collective's bytes at the rate of its axis's link.

There is no HLO: ``collective_bytes`` reads the collectives the dry run's
``CommDebugMode`` recorded (op, bytes, mesh axis), and returns the
reference's keys with its conventions: bytes = max(operand, result) tensor
size, all-reduce counted 2× (ring reduce-scatter + all-gather phases).

Also reported: MODEL_FLOPS = 6·N·D for training (2·N·D for serving; N the
active parameters), the useful-compute ratio MODEL_FLOPS / counted FLOPs,
the dominant term, and a one-line what-would-move-it-down note.  Every
number here is computed from ``HW``, not measured.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["collective_bytes", "roofline_terms", "analyze_dir",
           "format_table", "HW", "LINK_FOR_AXIS", "COLL_OPS"]

#: H100 SXM 80 GB constants (per GPU)
HW = {
    # bf16 dense on the tensor cores: NVIDIA H100 Tensor Core GPU datasheet,
    # SXM column (1,979 TFLOP/s is with 2:4 sparsity; dense is half)
    "peak_flops": 989e12,
    # float32 outside the tensor cores: the same datasheet, SXM column
    "peak_flops_f32": 67e12,
    # TF32 dense on the tensor cores: the same datasheet, SXM column (989
    # TFLOP/s is with 2:4 sparsity; dense is half).  The f32 flash kernels
    # take three tf32 instructions a product (the split of
    # csrc/sm90_common.cuh), so their bound is a third of this
    "peak_flops_tf32": 495e12,
    # HBM3 bandwidth: the same datasheet, SXM column (3.35 TB/s)
    "hbm_bw": 3.35e12,
    # NVLink 4: 900 GB/s per GPU both directions together (datasheet), so
    # 450 GB/s each way
    "nvlink_bw": 450e9,
    # InfiniBand NDR: one 400 Gb/s ConnectX-7 port per GPU (DGX H100 system
    # guide), 50 GB/s each way
    "ib_bw": 50e9,
}

#: the link each mesh axis of ``launch/mesh.py`` crosses
LINK_FOR_AXIS = {"model": "nvlink_bw", "data": "ib_bw", "pod": "ib_bw"}

COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, float, str]]
                     ) -> Dict[str, object]:
    """(op, bytes, mesh axis) per collective → bytes per op kind (all-reduce
    counted 2×), ``total``, ``counts`` per op kind, and ``by_axis``: the
    counted bytes per mesh axis."""
    out: Dict[str, object] = {k: 0.0 for k in COLL_OPS}
    counts = {k: 0 for k in COLL_OPS}
    by_axis: Dict[str, float] = {}
    for op, nbytes, axis in records:
        size = (2.0 if op == "all-reduce" else 1.0) * float(nbytes)
        out[op] += size
        counts[op] += 1
        by_axis[axis] = by_axis.get(axis, 0.0) + size
    out["total"] = sum(out[k] for k in COLL_OPS)
    out["counts"] = counts
    out["by_axis"] = by_axis
    return out


def collective_seconds(coll: Dict) -> float:
    """Each axis's collective bytes at its link's rate; bytes of an axis
    not in ``LINK_FOR_AXIS`` (or a record without ``by_axis``) at the
    slower InfiniBand rate."""
    by_axis = coll.get("by_axis")
    if by_axis is None:
        return float(coll["total"]) / HW["ib_bw"]
    return sum(float(b) / HW[LINK_FOR_AXIS.get(axis, "ib_bw")]
               for axis, b in by_axis.items())


_NOTES = {
    "compute": "raise arithmetic efficiency: cut non-model FLOPs (dispatch "
               "products, remat recompute) or shard the hot matmul wider",
    "memory": "cut HBM traffic: fuse elementwise chains (a hand-written "
              "kernel), shrink optimizer-state dtype, or keep tiles in "
              "shared memory",
    "collective": "cut wire bytes: int8-compressed gradient collectives, "
                  "reduce-scatter instead of all-reduce+slice, or move the "
                  "sharding so the all-gathered tensor is smaller or stays "
                  "on NVLink",
}

_TOKENS = {"train_4k": 4096 * 256, "prefill_32k": 32768 * 32,
           "decode_32k": 128, "long_500k": 1}


def roofline_terms(cell: Dict) -> Optional[Dict]:
    """cell: one dry-run record → roofline record.

    The counts are per device (the dry run counts one rank's local
    program), so each term divides by one GPU's rate; this equals the
    global / (GPUs × rate) formulation.  A cell of a shape outside
    ``SHAPES`` carries its own ``tokens`` and ``kind``.
    """
    if cell.get("skipped") or cell.get("flops") in (None, 0):
        return None
    chips = cell["num_devices"]
    flops = float(cell["flops"])              # per device
    byts = float(cell["bytes_accessed"] or 0.0)
    t_compute = flops / HW["peak_flops"]
    t_memory = byts / HW["hbm_bw"]
    t_coll = collective_seconds(cell["collectives"])
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    shape = cell["shape"]
    tokens = cell.get("tokens") or _TOKENS[shape]
    kind = cell.get("kind") or ("train" if shape == "train_4k" else "serve")
    mult = 6.0 if kind == "train" else 2.0
    model_flops = mult * cell["active_params"] * tokens
    hlo_flops_global = flops * chips
    bound = max(terms.values())
    return {
        "arch": cell["arch"],
        "shape": shape,
        "mesh": cell["mesh"],
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "dominant": dominant,
        "bound_s": bound,
        "model_flops": model_flops,
        "hlo_flops_global": hlo_flops_global,
        "useful_ratio": model_flops / hlo_flops_global if flops else 0.0,
        # fraction of the GPUs' peak that *useful* model FLOPs would occupy
        # if the step ran exactly at the dominant-term time
        "roofline_fraction": (model_flops / (chips * HW["peak_flops"])) /
                             bound if bound else 0.0,
        "note": _NOTES[dominant],
    }


def analyze_dir(dry_dir: str, mesh: str = "32x8") -> List[Dict]:
    rows = []
    for name in sorted(os.listdir(dry_dir)):
        if not name.endswith(f"__{mesh}.json"):
            continue
        with open(os.path.join(dry_dir, name)) as f:
            cell = json.load(f)
        r = roofline_terms(cell)
        if r:
            rows.append(r)
    return rows


def format_table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'compute':>10s} {'memory':>10s} "
           f"{'collect':>10s} {'dom':>10s} {'useful':>7s} {'roofl%':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} "
            f"{r['compute_s']*1e3:9.2f}ms {r['memory_s']*1e3:9.2f}ms "
            f"{r['collective_s']*1e3:9.2f}ms {r['dominant']:>10s} "
            f"{r['useful_ratio']:7.3f} {100*r['roofline_fraction']:6.1f}%")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="32x8")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = analyze_dir(args.dir, args.mesh)
    print(format_table(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=2)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
