#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch``, one ``nvcc`` per source, all at once: six sources, as
flash_attention has a bf16 tensor-core kernel, ``flash_attention_sm90.cu``,
and an f32 SIMT one), holds each kernel against its plain PyTorch version on
the card at the main paths' shapes and times both, then drives the two main
paths through the user entry points:

1. the placement search: ``HSDAG.search(..., engine="level")`` on
   Inception-v3 at the Table-6 widths (hidden 128, 2+2+2 layers, T=20) with
   16 chains for 3 episodes, followed by the greedy ``place()``
   (``level_makespan``, ``gcn_aggregate``);
2. LM serving: ``repro_torch.launch.serve`` at full width in bf16 with
   random weights, h2o-danube-1.8b (batch 4, prompt 4608 > its 4096 window,
   32 steps: ``rmsnorm``, ``flash_attention``) and mamba2-130m (batch 4,
   prompt 4096, 32 steps, SSD chunk 32: ``rmsnorm``, ``ssd_scan``), then a
   float32 check that prefill + greedy decode agrees with ``forward`` for
   each model.

Each path's kernel launch counters are zeroed just before it and read just
after it; every wall time is printed per phase.

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
H100_BF16_FLOPS = 989e12     # dense bf16 on the tensor cores
# flash_attention's bf16 time at danube's prefill shape on the SIMT kernel,
# before the tensor-core kernel took bf16 (PERF.md section 6: chip_smoke.py
# on an NVIDIA H100 80GB HBM3 at 700 W)
FLASH_SIMT_BF16_MS = 31.708

TOL = 1e-5
# LM kernels against their plain versions (normwise): f32 as above; bf16 as
# the reference's own kernel tests (tests/test_kernels.py:14-15)
LM_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}
# prefill + decode against forward at full width in float32
CONSISTENCY_TOL = 1e-4
# the main path's serves: (arch, batch, prompt, steps)
SERVES = (("h2o-danube-1.8b", 4, 4608, 32), ("mamba2-130m", 4, 4096, 32))


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


def bound_ms_bf16(nbytes: float, ops: float):
    """As ``bound_ms`` for work on the bf16 tensor cores."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lm_check(torch, name, got, want, dtype, worst):
    """Normwise check of a kernel against its plain version; → new worst
    max abs error."""
    torch.cuda.synchronize()
    tol = LM_TOL[str(dtype)]
    err = rel_err(torch, got.float(), want.float())
    abs_err = float((got.float() - want.float()).abs().max())
    print(f"[lm-kernels] {name}: rel err {err:.3e} (tol {tol:g}), max abs "
          f"err {abs_err:.3e}")
    check(bool(torch.isfinite(got.float()).all()) and err <= tol,
          f"{name} disagrees with its plain version")
    return max(worst, abs_err)


def rmsnorm_serve_shapes(torch):
    """Every rmsnorm launch of one main-path run, by shape:
    → [(arch, rows, d, dtype, launches)].

    Per forward, danube norms (rows, 2560) bf16 twice per layer and once at
    the end; mamba2 norms (rows, 768) bf16 once per layer and at the end,
    and its gated norm (rows, 1536) in f32 once per layer.  Prefill has
    batch·prompt rows and runs once; each of the steps−1 decode steps has
    batch rows."""
    from repro_torch.configs import get
    shapes = []
    for arch, batch, prompt, steps in SERVES:
        cfg = get(arch).config
        mixers = {m for m, _ in cfg.block_pattern}
        per_fwd = [(cfg.d_model, torch.bfloat16, cfg.n_layers * (
            2 if "attn" in mixers else 1) + 1)]
        if "mamba" in mixers:
            per_fwd.append((cfg.d_inner, torch.float32, cfg.n_layers))
        for rows, times in ((batch * prompt, 1), (batch, steps - 1)):
            shapes += [(arch, rows, d, dt, n * times)
                       for d, dt, n in per_fwd]
    return shapes


def rmsnorm_checks(torch):
    """rmsnorm at the main path's shapes: danube prefill (4·4608 × 2560),
    mamba2 prefill (4·4096 × 768) and its gated norm (4·4096 × 1536), each in
    f32 and bf16; then the kernel's time at every shape the serves launch it
    at (decode's 4-row norms included)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm, rmsnorm_ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for rows, d in ((4 * 4608, 2560), (4 * 4096, 768), (4 * 4096, 1536)):
        scale = torch.randn(d, generator=gen, device="cuda") + 1.0
        x32 = torch.randn(rows, d, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            worst = lm_check(torch, f"rmsnorm {rows}x{d} {dtype}",
                             rmsnorm(x, scale), rmsnorm_ref(x, scale), dtype,
                             worst)
    rows, d = 4 * 4608, 2560
    x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    scale = torch.randn(d, generator=gen, device="cuda") + 1.0
    ms, host = cuda_ms(torch, lambda: rmsnorm(x, scale), 50)
    plain, _ = cuda_ms(torch, lambda: rmsnorm_ref(x, scale), 20)
    # the library call takes the weight in x's dtype: a yardstick of speed
    w16 = scale.bfloat16()
    lib, _ = cuda_ms(torch, lambda: F.rms_norm(x, (d,), w16, 1e-6), 50)
    nbytes = 2 * rows * d * 2 + 4 * d
    ops = 4 * rows * d
    t = (ms, plain, *bound_ms(nbytes, ops), lib)
    print(f"[lm-kernels] rmsnorm timing {rows}x{d} bf16: kernel {ms:.4f} ms "
          f"on the card ({host:.4f} ms of host time to launch), plain "
          f"{plain:.4f} ms, F.rms_norm {lib:.4f} ms, bound {t[2]:.6f} ms "
          f"({t[3]}: {nbytes} B, {ops} ops)")

    # device time above the bound, summed over the serves' launches
    shapes = rmsnorm_serve_shapes(torch)
    excess = 0.0
    for arch, rows, d, dtype, n in shapes:
        x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        scale = torch.randn(d, generator=gen, device="cuda") + 1.0
        ms_s, _ = cuda_ms(torch, lambda: rmsnorm(x, scale),
                          50 if rows > 64 else 500)
        nbytes = 2 * rows * d * x.element_size() + 4 * d
        b_ms, _ = bound_ms(nbytes, 4 * rows * d)
        excess += n * max(ms_s - b_ms, 0.0)
        print(f"[lm-kernels] rmsnorm {arch} {rows}x{d} {dtype}: {n} launches"
              f" per main-path run, kernel {ms_s:.5f} ms, bound "
              f"{b_ms:.6f} ms, above the bound {n * (ms_s - b_ms):.4f} ms")
    print(f"[lm-kernels] rmsnorm device time above its bound over one "
          f"main-path run: {excess:.4f} ms")
    return worst, t, shapes


def flash_sm90_report():
    """The bf16 tensor-core flash kernel's build: per head dim, its registers
    and spills from nvcc's ``-Xptxas -v`` log and the dynamic shared memory
    a block takes."""
    import ctypes
    import re
    from repro_torch.kernels._build import _lib_path, library
    smem = library("flash_attention_sm90").flash_attention_bf16_sm90_smem
    smem.restype, smem.argtypes = ctypes.c_int, [ctypes.c_int]
    log = _lib_path("flash_attention_sm90").with_suffix(".log").read_text()
    d = None
    for line in log.splitlines():
        entry = re.search(r"flash_attention_sm90_kernelILi(\d+)E", line)
        if entry and "Compiling entry" in line:
            d = int(entry.group(1))
        elif d is not None and ("registers" in line or "spill" in line):
            print(f"[build] flash_attention_sm90 D={d}: {line.strip()}"
                  + (f"; dynamic shared memory {smem(d)} B per block"
                     if "registers" in line else ""))


def flash_checks(torch):
    """flash_attention on both routes, each case against
    ``flash_attention_ref``: bf16 through the tensor-core kernel
    (``csrc/flash_attention_sm90.cu``) at danube's prefill shape (B=4, H=32,
    KV=8, S=4608, D=80, window 4096) and at D=64/80/128 with GQA, MHA, a
    window edge inside a tile, a ragged S and causal=False; f32 through the
    SIMT kernel (``csrc/flash_attention.cu``) at batch 1 of danube's shape and
    the small cases.  Then the bf16 kernel's time beside
    ``scaled_dot_product_attention`` on the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import (flash_attention, flash_attention_ref,
                                     flash_pairs)
    from repro_torch.kernels.flash_attention import flash_mask
    gen = torch.Generator(device="cuda").manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    routes = {f32: "simt_f32", bf16: "wgmma_bf16"}

    def qkv(b, h, kv, s, d, dtype):
        return (torch.randn(b, h, s, d, generator=gen, device="cuda")
                .to(dtype),
                torch.randn(b, kv, s, d, generator=gen, device="cuda")
                .to(dtype),
                torch.randn(b, kv, s, d, generator=gen, device="cuda")
                .to(dtype))

    worst = 0.0
    cases = [((1, 32, 8, 4608, 80), True, 4096, f32),
             ((2, 8, 2, 700, 64), True, 256, f32),
             ((1, 4, 1, 333, 128), True, 0, f32),
             ((1, 4, 2, 300, 80), False, 64, f32),
             ((2, 8, 2, 700, 64), True, 256, bf16),
             ((1, 4, 1, 333, 128), True, 0, bf16),
             ((1, 8, 2, 333, 80), True, 100, bf16),   # window edge in a tile
             ((2, 4, 4, 520, 64), True, 0, bf16),     # KV = H
             ((1, 8, 2, 777, 64), True, 300, bf16),   # H / KV = 4
             ((2, 4, 4, 520, 128), True, 0, bf16),
             ((1, 8, 2, 777, 128), True, 300, bf16),
             ((2, 8, 8, 640, 80), True, 0, bf16),
             ((1, 4, 2, 300, 80), False, 64, bf16),   # window not applied
             ((1, 4, 1, 1000, 64), False, 0, bf16),
             ((1, 4, 1, 333, 128), False, 0, bf16)]
    for shape, causal, window, dtype in cases:
        q, k, v = qkv(*shape, dtype)
        before = dict(flash_attention.route_launches)
        got = flash_attention(q, k, v, causal=causal, window=window)
        route = routes[dtype]
        check(flash_attention.route_launches[route] == before[route] + 1,
              f"flash_attention {shape} {dtype} did not take the {route} "
              f"kernel")
        worst = lm_check(
            torch, f"flash_attention[{route}] {shape} causal={causal} "
            f"window={window} {dtype}", got,
            flash_attention_ref(q, k, v, causal=causal, window=window),
            dtype, worst)
        del q, k, v, got
    B, H, KV, S, D, W = 4, 32, 8, 4608, 80, 4096
    q, k, v = qkv(B, H, KV, S, D, bf16)
    got = flash_attention(q, k, v, window=W)
    want = flash_attention_ref(q, k, v, window=W)
    worst = lm_check(torch, f"flash_attention[wgmma_bf16] {(B, H, KV, S, D)} "
                     f"causal=True window={W} bf16", got, want, bf16, worst)
    mask = flash_mask(S, True, W, "cuda")
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
    else:   # torch < 2.5: the same call on K/V repeated to H heads
        k_h = k.repeat_interleave(H // KV, dim=1)
        v_h = v.repeat_interleave(H // KV, dim=1)

        def library():
            return F.scaled_dot_product_attention(q, k_h, v_h, attn_mask=mask)
    lib_out = library()
    lib_err = rel_err(torch, lib_out.float(), want.float())
    del got, want, lib_out
    ms, host = cuda_ms(torch, lambda: flash_attention(q, k, v, window=W), 20)
    lib, _ = cuda_ms(torch, library, 10)
    ms2, _ = cuda_ms(torch, lambda: flash_attention(q, k, v, window=W), 20)
    plain, _ = cuda_ms(torch, lambda: flash_attention_ref(q, k, v, window=W),
                       2, 1)
    # the pair count comes from the kernel's own tile plan
    pairs, visited = flash_pairs(S, True, W)
    check(pairs == int(mask.sum()), "flash_pairs disagrees with the mask")
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * S * D)
    ops = 4 * B * H * D * pairs
    t = (min(ms, ms2), plain, *bound_ms_bf16(nbytes, ops), lib)
    print(f"[lm-kernels] flash_attention timing {(B, H, KV, S, D)} window "
          f"{W} bf16: tensor-core kernel {ms:.4f} / {ms2:.4f} ms on the card "
          f"(two runs around the library's; {host:.4f} ms of host time to "
          f"launch), {ops / (t[0] * 1e-3) / 1e12:.1f} TFLOP/s on the "
          f"unmasked pairs, {100 * t[2] / t[0]:.1f} % of the bound; "
          f"before: the SIMT kernel {FLASH_SIMT_BF16_MS} ms (PERF.md); "
          f"scaled_dot_product_attention(mask, enable_gqa) {lib:.4f} ms "
          f"(rel err vs plain {lib_err:.2e}); plain {plain:.3f} ms; bound "
          f"{t[2]:.6f} ms ({t[3]}: {nbytes} B, {ops} ops over {pairs} "
          f"unmasked (query, key) pairs per head; the visited tiles hold "
          f"{visited}); design goal half the bound "
          f"({2 * t[2]:.4f} ms): {'met' if t[0] <= 2 * t[2] else 'not met'}")
    check(t[0] < lib, f"the bf16 flash_attention kernel ({t[0]:.4f} ms) is "
          f"not faster than scaled_dot_product_attention ({lib:.4f} ms)")
    return worst, t


def ssd_scan_checks(torch):
    """ssd_scan at mamba2-130m's prefill (B=4, prompt 4096, chunk 32 → C=128,
    H=24, P=64, N=128), f32."""
    from repro_torch.kernels import ssd_scan, ssd_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, C, H, P, N = 4, 128, 24, 64, 128
    dec = 0.3 + 0.699 * torch.rand(B, C, H, generator=gen, device="cuda")
    dbx = torch.randn(B, C, H, P, N, generator=gen, device="cuda")
    kb, kf = ssd_scan(dec, dbx)
    rb, rf = ssd_scan_ref(dec, dbx)
    worst = lm_check(torch, f"ssd_scan h_before {(B, C, H, P, N)}", kb, rb,
                     torch.float32, 0.0)
    worst = lm_check(torch, f"ssd_scan h_final {(B, H, P, N)}", kf, rf,
                     torch.float32, worst)
    del kb, kf, rb, rf
    ms, host = cuda_ms(torch, lambda: ssd_scan(dec, dbx), 20)
    plain, _ = cuda_ms(torch, lambda: ssd_scan_ref(dec, dbx), 3, 1)
    nbytes = 4 * (B * C * H + 2 * B * C * H * P * N + B * H * P * N)
    ops = 2 * B * C * H * P * N
    t = (ms, plain, *bound_ms(nbytes, ops), None)
    print(f"[lm-kernels] ssd_scan timing {(B, C, H, P, N)}: kernel "
          f"{ms:.4f} ms on the card ({host:.4f} ms of host time to launch), "
          f"plain {plain:.3f} ms, bound {t[2]:.6f} ms ({t[3]}: {nbytes} B, "
          f"{ops} ops)")
    return worst, t


def serve_phase(torch, arch, batch, prompt, steps):
    """Drive ``repro_torch.launch.serve`` at full width; → launches."""
    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    from repro_torch.launch import serve
    kernels = (rmsnorm, flash_attention, ssd_scan)
    cfg = get(arch).config
    for k in kernels:
        k.launches = 0
    for route in flash_attention.route_launches:
        flash_attention.route_launches[route] = 0
    t0 = time.perf_counter()
    res = serve.main(["--arch", arch, "--batch", str(batch), "--prompt",
                      str(prompt), "--steps", str(steps)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    launches.update(flash_attention.route_launches)
    print(f"[serve] {arch} {cfg.dtype} B={batch} prompt={prompt} "
          f"steps={steps}: prefill {res.prefill_ms:.3f} ms, decode "
          f"{res.decode_ms:.3f} ms for {steps - 1} steps "
          f"({res.decode_tok_s:.1f} tok/s), wall {wall:.3f} s (weights "
          f"included); launches {launches}")
    check(tuple(res.tokens.shape) == (batch, steps)
          and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_size,
          f"{arch} serve returned invalid tokens")
    mixers = {m for m, _ in cfg.block_pattern}
    check(launches["rmsnorm"] > 0, f"{arch} serve launched no rmsnorm")
    want_flash = cfg.n_layers if "attn" in mixers else 0
    want_ssd = cfg.n_layers if "mamba" in mixers else 0
    check(launches["flash_attention"] == want_flash,
          f"{arch} serve launched flash_attention "
          f"{launches['flash_attention']} times, not {want_flash}")
    # the bf16 serve runs every layer's prefill attention on the tensor-core
    # kernel, none on the SIMT one
    check(launches["wgmma_bf16"] == want_flash
          and launches["simt_f32"] == 0,
          f"{arch} serve launched the bf16 tensor-core flash kernel "
          f"{launches['wgmma_bf16']} times and the f32 SIMT kernel "
          f"{launches['simt_f32']} times, not {want_flash} and 0")
    check(launches["ssd_scan"] == want_ssd,
          f"{arch} serve launched ssd_scan {launches['ssd_scan']} times, "
          f"not {want_ssd}")
    return launches


def decode_consistency(torch, arch, prompt, n, batch=2):
    """Full-width float32: prefill(prompt) + n greedy decode steps against
    forward over prompt + generated (tests/test_models.py:21)."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.models import (decode_step, forward, init_params,
                                    prefill)
    cfg = dataclasses.replace(get(arch).config, dtype="float32")
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = init_params(cfg, seed=0, device="cuda")
        gen = torch.Generator().manual_seed(5)
        toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                             generator=gen, dtype=torch.int32).cuda()
        logits, caches = prefill(params, cfg, toks, ssd_chunk=32,
                                 max_len=prompt + n)
        steps = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        gen_toks = [tok]
        for i in range(n - 1):
            logits, caches = decode_step(params, cfg, tok, caches, prompt + i)
            steps.append(logits[:, -1])
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            gen_toks.append(tok)
        seq = torch.cat([toks] + gen_toks[:-1], dim=1)
        full = forward(params, cfg, seq, ssd_chunk=32)[:, prompt - 1:]
        got = torch.stack(steps, dim=1)
        torch.cuda.synchronize()
    err = rel_err(torch, got, full)
    same = bool(torch.equal(torch.cat(gen_toks, 1),
                            torch.argmax(full, -1).to(torch.int32)))
    print(f"[consistency] {arch} float32 B={batch} prompt={prompt} + {n} "
          f"decode steps vs forward: logits rel err {err:.3e} (tol "
          f"{CONSISTENCY_TOL:g}), greedy tokens equal: {same} "
          f"({time.perf_counter() - t0:.2f} s)")
    check(err <= CONSISTENCY_TOL and same,
          f"{arch} decode disagrees with forward")
    del params, caches


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

    t_start = time.perf_counter()
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
    flash_sm90_report()

    plat = paper_platform()
    graphs = {name: build() for name, build in PAPER_BENCHMARKS.items()}
    lvl_err, lvl_t = level_checks(torch, graphs, plat)
    gcn_err, gcn_t = gcn_checks(torch, graphs)

    # ---- the main path: search (engine="level") then greedy place() ----
    g = graphs["inception_v3"]
    arrays = extract_features(g)
    cfg = HSDAGConfig(batch_chains=16, engine="level", max_episodes=3)
    agent = HSDAG(cfg)
    t_phase = time.perf_counter()
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

    print(f"[phase] search + place: {time.perf_counter() - t_phase:.2f} s")

    # ---- the LM kernels against their plain versions ----
    t_phase = time.perf_counter()
    rms_err, rms_t, rms_shapes = rmsnorm_checks(torch)
    flash_err, flash_t = flash_checks(torch)
    ssd_err, ssd_t = ssd_scan_checks(torch)
    torch.cuda.empty_cache()
    print(f"[phase] LM kernel checks: {time.perf_counter() - t_phase:.2f} s")

    # ---- the LM main path: serve both models at full width (bf16) ----
    t_phase = time.perf_counter()
    from repro_torch.launch import serve
    # warm-up (cuBLAS handles, allocator) before the counted runs
    serve.main(["--arch", "h2o-danube-1.8b", "--batch", "1", "--prompt",
                "128", "--steps", "2"])
    torch.cuda.empty_cache()
    served = {}
    for arch, batch, prompt, steps in SERVES:
        served[arch] = serve_phase(torch, arch, batch, prompt, steps)
        torch.cuda.empty_cache()
        want = sum(n for a, *_, n in rms_shapes if a == arch)
        check(served[arch]["rmsnorm"] == want,
              f"{arch} serve launched rmsnorm {served[arch]['rmsnorm']} "
              f"times, not the {want} its timing counted")
    danube, mamba = served["h2o-danube-1.8b"], served["mamba2-130m"]
    print(f"[phase] serve: {time.perf_counter() - t_phase:.2f} s")

    # ---- decode consistency at full width, float32, TF32 off ----
    t_phase = time.perf_counter()
    decode_consistency(torch, "h2o-danube-1.8b", 200, 8)
    torch.cuda.empty_cache()
    decode_consistency(torch, "mamba2-130m", 200, 8)
    print(f"[phase] decode consistency: {time.perf_counter() - t_phase:.2f} s")

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
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:24",
         "launches": danube["rmsnorm"] + mamba["rmsnorm"],
         "max_abs_err": rms_err, "ms": rms_t[0], "plain_ms": rms_t[1],
         "bound_ms": rms_t[2], "bound_by": rms_t[3], "library_ms": rms_t[4]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:35",
         "launches": danube["wgmma_bf16"] + mamba["wgmma_bf16"],
         "max_abs_err": flash_err, "ms": flash_t[0], "plain_ms": flash_t[1],
         "bound_ms": flash_t[2], "bound_by": flash_t[3],
         "library_ms": flash_t[4]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:27",
         "launches": danube["ssd_scan"] + mamba["ssd_scan"],
         "max_abs_err": ssd_err, "ms": ssd_t[0], "plain_ms": ssd_t[1],
         "bound_ms": ssd_t[2], "bound_by": ssd_t[3], "library_ms": ssd_t[4]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(f"[done] total wall {time.perf_counter() - t_start:.2f} s")
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
