#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch``), holds each kernel against its plain PyTorch version
on the card at the main path's shapes and times both, then drives the main
path through the user entry points: ``HSDAG.search(..., engine="level")`` on
Inception-v3 at the Table-6 widths (hidden 128, 2+2+2 layers, T=20) with 16
chains for 3 episodes, followed by the greedy ``place()``.  The kernels'
launch counters are zeroed just before that run and read just after it.

Lines it prints, in order: phase results, one JSON line
``{"kernels": [...]}``, the card's name and power limit as ``nvidia-smi``
reports them, and last ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero before the last line.  Without a CUDA device, or outside a
checkout (no ``src/repro_torch`` beside it), it exits non-zero and prints no
result.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12

TOL = 1e-5


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2):
    """→ (device ms, host ms) per call of ``fn``, over ``iters`` calls.

    A spin kernel holds the stream while the host queues all ``iters``
    calls, so the events time the device's work and not the host's launch
    rate (a short kernel takes less time on the card than its wrapper takes
    to launch it from Python); the host time is what queueing one call cost.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    lead_s = min(1.5 * iters * (time.perf_counter() - t0) + 1e-3, 5.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(lead_s * 2e9))      # ~2 GHz SM clock
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(torch, got, want) -> float:
    """max |got − want| / max |want| (normwise relative error)."""
    scale = want.abs().max().clamp_min(1e-30)
    return float((got - want).abs().max() / scale)


def level_checks(torch, graphs, plat):
    from repro_torch.core.sim import LevelBackend
    from repro_torch.kernels import level_makespan, level_makespan_ref
    backend = LevelBackend(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    timing = None
    for name, g in graphs.items():
        prep = backend.prepare(g, plat)
        sim, lt = prep.sim, prep.tables
        B, V = 320, g.num_nodes
        place = torch.randint(0, plat.num_devices, (B, V), generator=gen,
                              device="cuda", dtype=torch.int32)
        args = (lt, place, sim["queue_init"], sim["inv_bw"], sim["lat"])
        fk, tk = level_makespan(*args)
        fr, tr = level_makespan_ref(*args)
        torch.cuda.synchronize()
        e_f, e_t = rel_err(torch, fk, fr), rel_err(torch, tk, tr)
        abs_err = float(max((fk - fr).abs().max(), (tk - tr).abs().max()))
        worst = max(worst, abs_err)
        L, W = lt.nodes_host.shape
        P, D = lt.preds.shape[2], sim["inv_bw"].shape[0]
        print(f"[kernels] level_makespan {name}: B={B} V={V} L={L} W={W} "
              f"P={P} finish rel err {e_f:.3e}, transfer rel err {e_t:.3e}, "
              f"max abs err {abs_err:.3e}")
        check(e_f <= TOL and e_t <= TOL,
              f"level_makespan disagrees with its plain version on {name}")
        if name == "inception_v3":
            Q = sim["queue_init"].shape[1]
            ms, host = cuda_ms(torch, lambda: level_makespan(*args), 50)
            plain, _ = cuda_ms(torch, lambda: level_makespan_ref(*args), 2, 1)
            real = int((lt.nodes_host != V).sum())
            nbytes = 4 * (L * W + 3 * L * W * P + L * W * D + B * V
                          + 2 * D * D + D * Q + B * (V + 1) + B)
            ops = B * real * (5 * P + Q + 2)
            timing = (ms, plain, *bound_ms(nbytes, ops))
            print(f"[kernels] level_makespan timing at inception_v3, B={B}: "
                  f"kernel {ms:.4f} ms on the card ({host:.4f} ms of host "
                  f"time to launch), plain {plain:.3f} ms, bound "
                  f"{timing[2]:.6f} ms ({timing[3]}: {nbytes} B, {ops} ops)")
    return worst, timing


def gcn_checks(torch, graphs):
    from repro_torch.core.gnn import normalize_adjacency
    from repro_torch.kernels import (GCNAggregate, gcn_aggregate,
                                     gcn_aggregate_ref, gcn_graph)
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    timing = None
    B, F = 16, 128
    for name, g in graphs.items():
        V, E = g.num_nodes, g.num_edges
        graph = gcn_graph(g.edges, V, "cuda")
        keep = (torch.rand(B, E, generator=gen, device="cuda") < 0.8).float()
        h = torch.randn(B, V, F, generator=gen, device="cuda")
        gout = torch.randn(B, V, F, generator=gen, device="cuda")
        out_k = gcn_aggregate(graph, keep, h)
        out_r = gcn_aggregate_ref(graph, keep, h)
        hk = h.clone().requires_grad_(True)
        (gk,) = torch.autograd.grad(GCNAggregate.apply(graph, keep, hk), hk,
                                    gout)
        hr = h.clone().requires_grad_(True)
        (gr,) = torch.autograd.grad(gcn_aggregate_ref(graph, keep, hr), hr,
                                    gout)
        torch.cuda.synchronize()
        e_f, e_b = rel_err(torch, out_k, out_r), rel_err(torch, gk, gr)
        abs_err = float(max((out_k - out_r).abs().max(),
                            (gk - gr).abs().max()))
        worst = max(worst, abs_err)
        print(f"[kernels] gcn_aggregate {name}: B={B} V={V} E={E} F={F} "
              f"forward rel err {e_f:.3e}, backward rel err {e_b:.3e}, "
              f"max abs err {abs_err:.3e}")
        check(e_f <= TOL and e_b <= TOL,
              f"gcn_aggregate disagrees with its plain version on {name}")
        if name == "inception_v3":
            adj = torch.zeros(B, V, V, device="cuda")
            bidx = torch.arange(B, device="cuda")[:, None]
            adj[bidx, graph.src[None], graph.dst[None]] = keep
            a_hat = normalize_adjacency(adj)
            lib_err = rel_err(torch, torch.bmm(a_hat, h), out_r)
            ms, host = cuda_ms(torch, lambda: gcn_aggregate(graph, keep, h),
                               100)
            plain, _ = cuda_ms(torch,
                               lambda: gcn_aggregate_ref(graph, keep, h), 50)
            lib, _ = cuda_ms(torch, lambda: torch.bmm(a_hat, h), 100)
            nbytes = 4 * (2 * B * V * F + B * E + (V + 1) + 4 * E)
            ops = B * F * (2 * V + 6 * E) + B * (2 * E + 2 * V)
            timing = (ms, plain, *bound_ms(nbytes, ops), lib)
            print(f"[kernels] gcn_aggregate timing at inception_v3, B={B}, "
                  f"F={F}: kernel {ms:.4f} ms on the card ({host:.4f} ms of "
                  f"host time to launch), plain {plain:.4f} ms, "
                  f"torch.bmm(dense Â, H) {lib:.4f} ms (rel err vs plain "
                  f"{lib_err:.2e}), bound {timing[2]:.6f} ms ({timing[3]}: "
                  f"{nbytes} B, {ops} ops)")
    return worst, timing


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch import (HSDAG, HSDAGConfig, PAPER_BENCHMARKS,
                             extract_features, paper_platform, simulate)
    from repro_torch.core.sim import LevelBackend
    from repro_torch.kernels import gcn_aggregate, level_makespan
    from repro_torch.kernels._build import build_all, build_dir

    # Full float32 everywhere: the checks below compare at 1e-5.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"card: {card}; allow_tf32 off for matmul and cuDNN")

    t0 = time.perf_counter()
    built = build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s wall, nvcc per source "
          f"{ {k: round(v, 2) for k, v in built.items()} } into "
          f"{build_dir()}")
    for log in sorted(build_dir().glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {log.stem}: {line.strip()}")

    plat = paper_platform()
    graphs = {name: build() for name, build in PAPER_BENCHMARKS.items()}
    lvl_err, lvl_t = level_checks(torch, graphs, plat)
    gcn_err, gcn_t = gcn_checks(torch, graphs)

    # ---- the main path: search (engine="level") then greedy place() ----
    g = graphs["inception_v3"]
    arrays = extract_features(g)
    cfg = HSDAGConfig(batch_chains=16, engine="level", max_episodes=3)
    agent = HSDAG(cfg)
    level_makespan.launches = 0
    gcn_aggregate.launches = 0
    t0 = time.perf_counter()
    res = agent.search(g, arrays, platform=plat)
    placement = agent.place(arrays)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"level_makespan": level_makespan.launches,
                "gcn_aggregate": gcn_aggregate.launches}
    for h in res.history:
        print(f"[search] episode {h['episode']}: wall {h['wall_s']:.3f} s, "
              f"mean reward {h['mean_reward']:.4f}, best "
              f"{h['best_latency'] * 1e3:.6f} ms, mean groups "
              f"{h['mean_groups']:.1f}")
    cpu_lat = simulate(g, [0] * g.num_nodes, plat).latency
    gpu_lat = simulate(g, [1] * g.num_nodes, plat).latency
    print(f"[search] inception_v3 B=16 T=20 hidden=128: "
          f"{res.num_evaluations} evaluations in {res.wall_time_s:.3f} s "
          f"({res.evals_per_sec:.1f} evals/s); best {res.best_latency * 1e3:.6f}"
          f" ms; cpu_only {cpu_lat * 1e3:.6f} ms, gpu_only "
          f"{gpu_lat * 1e3:.6f} ms (host simulate)")
    print(f"[search] launches over search + place(): {launches} "
          f"(search + place took {main_s:.3f} s)")
    check(launches["level_makespan"] >= cfg.max_episodes,
          "the search scored no window through the level kernel")
    check(launches["gcn_aggregate"] > 0,
          "the encoder never launched the gcn kernel")

    order = LevelBackend(device="cuda").prepare(g, plat).arrays.order
    host = simulate(g, res.best_placement, plat, order=order).latency
    print(f"[search] best placement on the host scheduler (level order): "
          f"{host * 1e3:.6f} ms vs kernel {res.best_latency * 1e3:.6f} ms")
    check(abs(res.best_latency - host) <= TOL * host,
          "best latency disagrees with the host scheduler")

    check(placement.shape == (g.num_nodes,)
          and placement.min() >= 0 and placement.max() < plat.num_devices,
          "place() returned an invalid placement")
    greedy = simulate(g, placement, plat).latency
    print(f"[place] greedy placement: {int((placement == 1).sum())} of "
          f"{g.num_nodes} nodes on GPU, latency {greedy * 1e3:.6f} ms")
    check(greedy == greedy and greedy > 0, "greedy latency is not finite")

    kernels = [
        {"name": "level_makespan", "route": "cuda",
         "source": "src/repro_torch/csrc/levelsim.cu",
         "replaces": "src/repro/kernels/levelsim.py:131",
         "launches": launches["level_makespan"], "max_abs_err": lvl_err,
         "ms": lvl_t[0], "plain_ms": lvl_t[1], "bound_ms": lvl_t[2],
         "bound_by": lvl_t[3], "library_ms": None},
        {"name": "gcn_aggregate", "route": "cuda",
         "source": "src/repro_torch/csrc/gcn_spmm.cu",
         "replaces": "src/repro/kernels/gcn_spmm.py:31",
         "launches": launches["gcn_aggregate"], "max_abs_err": gcn_err,
         "ms": gcn_t[0], "plain_ms": gcn_t[1], "bound_ms": gcn_t[2],
         "bound_by": gcn_t[3], "library_ms": gcn_t[4]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
