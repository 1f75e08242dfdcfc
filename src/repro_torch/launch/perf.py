"""Perf hill-climbing over the port's dry run.

Port of ``repro/launch/perf.py``.  Runs a named variant of one (arch ×
shape) cell — a sharding-rule and/or config change — through
``launch/dryrun.run_cell`` and prints the three roofline terms (computed
from ``launch/roofline.HW``, not measured):

    python -m repro_torch.launch.perf --arch command-r-plus-104b \\
        --shape train_4k --variant sp

``VARIANTS`` are the reference's but its ``qchunk_*``, which change
``attn_q_chunk``: the port has no query chunk (the flash kernel holds no
(chunk, S) scores; ``models/config.UNREAD``).  Combine variants with '+'.
"""
import argparse
import json
import os
import sys

__all__ = ["VARIANTS", "main"]

VARIANTS = {
    "baseline": ({}, {}),
    "sp": ({"res_seq": "model"}, {}),
    "fsdp_off": ({"embed": None}, {}),
    "opt_bf16": ({}, {"optimizer_state_dtype": "bfloat16"}),
    "opt_f32": ({}, {"optimizer_state_dtype": "float32"}),
    "moe_g256": ({}, {"moe_group_size": 256}),
    "moe_g128": ({}, {"moe_group_size": 128}),
    "moe_g512": ({}, {"moe_group_size": 512}),
    "cap1": ({}, {"capacity_factor": 1.0}),
    "remat_off": ({}, {"remat": False}),
    "remat_dots": ({}, {"remat_policy": "dots"}),
    "accum4": ({}, {"grad_accum": 4}),
    "accum8": ({}, {"grad_accum": 8}),
    "wq_int8": ({}, {"quantize_weights": True}),
    "seqdata": ({"res_seq": "data", "batch": None}, {}),  # decode batch=1
    "headdim_tp": ({"head_dim": "model"}, {}),   # shard attention on head_dim
    "head_merge": ({}, {"attn_head_merge": True}),  # (B×H)-merged attention
    "expert_data": ({"expert_mlp": "data"}, {}),  # expert weights 256-way
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--out", default="results/perf")
    args = ap.parse_args(argv)

    rules, overrides = {}, {}
    for part in args.variant.split("+"):
        r, o = VARIANTS[part]
        rules.update(r)
        overrides.update(o)

    from .dryrun import run_cell
    from .roofline import roofline_terms

    res = run_cell(args.arch, args.shape, extra_rules=rules or None,
                   config_overrides=overrides or None)
    res["variant"] = args.variant
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(
        args.out, f"{args.arch}__{args.shape}__{args.variant}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=2, default=str)

    print(f"\n=== {args.arch} × {args.shape} × {args.variant} ===")
    if res.get("skipped"):
        print(f"skipped: {res['skipped']}")
        return 0
    r = roofline_terms(res)
    mem = res.get("memory") or {}
    print(f"compute    {r['compute_s']*1e3:10.2f} ms")
    print(f"memory     {r['memory_s']*1e3:10.2f} ms")
    print(f"collective {r['collective_s']*1e3:10.2f} ms")
    print(f"dominant   {r['dominant']}   useful={r['useful_ratio']:.3f}   "
          f"roofline={100*r['roofline_fraction']:.1f}%")
    print(f"temp {mem.get('temp_size_in_bytes', 0)/1e9:.2f} GB/dev   "
          f"args {mem.get('argument_size_in_bytes', 0)/1e9:.2f} GB/dev")
    print(f"(saved {path}; computed for H100 SXM 80 GB constants, not "
          f"measured)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
