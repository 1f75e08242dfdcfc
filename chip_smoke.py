#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch``, one ``nvcc`` per source, all at once: eight sources,
as flash_attention has a bf16 tensor-core kernel, ``flash_attention_sm90.cu``,
with its tensor-core backward, ``flash_attention_bwd_sm90.cu``, and an f32
SIMT one with its SIMT backward, ``flash_attention_bwd.cu``), holds each
kernel against its plain PyTorch version on
the card at the main paths' shapes and on every route a kernel has
(level_makespan's staged and general routes, bitwise, on the three paper
graphs at B = 1, 7, 320 and 4096, a DAG wider than a warp, the
four-device platform and eight-GPU fleets of one and two queues a device,
on the level backend's tables and on the scan backend's chain tables of one
node a row, ``node_scan``, whose backend is also held against the host
scheduler; rmsnorm's warp, block and general
routes over rows x widths x dtypes; gcn_aggregate's float4 and scalar routes
and the SAGE mean aggregation ``sage_aggregate`` on the three paper graphs,
forward and backward, also at the joint trainer's B=8 and, on chain
tables, B=80) and times both, then drives the main paths through the
user entry points:

1. the placement search: ``HSDAG(HSDAGConfig(batch_chains=16)).search``
   with the default engine (the ``scan`` reward: ``level_makespan`` on
   chain tables) on Inception-v3 at the Table-6 widths (hidden 128, 2+2+2
   layers, T=20) for 3 episodes, followed by the greedy ``place()``
   (``level_makespan``, ``gcn_aggregate``); then one episode with
   ``engine="level"``; then the search's other paths on Inception-v3: a
   4-episode population search (a cull every window, a greedy restart every
   second), 3 episodes of ``k_epochs=2`` with ``dropout_parsing=0.1``, a
   sampled ``place(greedy=False)``, 3 episodes with ``gnn_model="sage"``
   (``sage_aggregate``) and its ``place()``, and one episode of the scalar
   loop (B=1, a host ``reward_fn``); then the device head
   (``head="device"``) on Inception-v3 over ``nvlink_island(2, 4)``: 3
   episodes with the default engine and ``place()``, 1 with
   ``engine="level"``, 2 of a population with a greedy restart every window;
   then its capacity mask on a fleet whose second island cannot hold 8 of
   the graph's nodes (every sampled placement must fit); then Table 13 on
   the card (``series_parallel_dag(20)`` on four fleets: the exact DP bound,
   the best single device, the dense and device heads' searches and the
   hybrid refinement, held against the bound and against the reference's
   bound in ``tools/reference_topology_spread.json``); then the quality
   contract: the port's best latency over seeds 0-11 on each paper graph
   with the default and the level engine (``HSDAGConfig(batch_chains=16,
   max_episodes=3)``) held against the reference's
   (``tools/reference_search_spread.json``), and the device head's on two
   Table-13 fleets against ``tools/reference_topology_spread.json``, by a
   one-sided Mann-Whitney test, failing at p < 1e-3, and joint training's
   (``MultiGraphTrainer(HSDAGConfig(num_devices=2, batch_chains=8,
   max_episodes=3, update_timestep=10))``: each paper graph's joint best
   and BERT-base's zero-shot greedy latency after training on Inception-v3
   and ResNet-50, seeds 0-11) against
   ``tools/reference_multi_spread.json``; then Table 7
   (``benchmarks/table7_generalization.py``) on the card: one
   ``MultiGraphTrainer`` over the three paper graphs (12 episodes, T=10,
   B=8), the three held-out runs (train on two, ``evaluate_zero_shot`` on
   the third) and a ``save_policy`` / ``load_policy`` round trip that must
   decode the same greedy placements; then Table 2
   (``benchmarks/table2_placement.py``: per paper graph the heuristic rows,
   ``PlacetoBaseline`` and ``RNNBaseline`` for 12 episodes, and the HSDAG
   row through ``PlacementSession``) and Table 4 (``MeasuredExecutor`` on
   BERT-base over the CPU and the card, under cpu_only and the Table-2
   placement); the contract also holds the learned baselines
   (``tools/reference_baseline_spread.json``) and corpus training over
   Table 8's full corpus (``tools/reference_corpus_spread_full.json``);
   Table 8 runs its full corpus, ``traced`` included; then the v1 API
   (``fit`` in each mode, save/load, ``plan_stages`` of phi3-mini-3.8b);
   then the placement service (``[service]``: a corpus policy at hidden 128
   over the paper graphs and six synthetics, saved and served from the
   checkpoint by ``PlacementService`` one request at a time, as one
   ``place_many`` burst and through ``AsyncPlacementServer``, each
   placement the session's exactly, ``gcn_aggregate`` launched
   ``layer_gnn`` times a request, and a second service on the same AOT
   directory with no cold bucket), Table 9
   (``benchmarks/table9_serving.py``'s cold, warm and batched rows) and
   Table 11 (``benchmarks/table11_server.py``'s two-tenant replay, cold on
   an empty AOT directory within the recompile bound, warm with none);
   then the sharded corpus trainer (``[sharded]``: a child process on an
   NCCL group of one rank trains Table 8's full corpus at hidden 128 for 3
   episodes unsharded and at ``mesh_shape=(1, 1)`` under deterministic
   algorithms, bit for bit, with equal kernel launches; then at 1×1 with
   the episodic population, the host's replay weights against
   ``update="fused"``, within 1e-5; the sharded PBT round bit for bit) and
   Table 10 (``[table10]``: ``tools/port_table10.py``'s throughput row on
   the card at mesh 1×1 on the child's NCCL group, and its memory rows at
   24 graphs);
2. LM serving: ``repro_torch.launch.serve`` at full width in bf16 with
   random weights, h2o-danube-1.8b (batch 4, prompt 4608 > its 4096 window,
   32 steps: ``rmsnorm``, ``flash_attention``) and mamba2-130m (batch 4,
   prompt 4096, 32 steps, SSD chunk 32: ``rmsnorm``, ``ssd_scan``) and
   phi3-mini-3.8b (batch 4, prompt 4064, 32 steps: ``flash_attention`` at
   head dim 96), then a float32 check that prefill + greedy decode agrees
   with ``forward`` for each model;
3. the other six archs' serves in bf16: olmoe-1b-7b at full width and
   depth (batch 4, prompt 4064, 32 steps: capacity-routed MoE, 64 experts
   top-8, ``flash_attention`` at head dim 128), printing the assignments
   its prefill drops at capacity and its weights' bytes; musicgen-medium at
   full depth (layernorm and GELU: no ``rmsnorm``); mixtral-8x22b,
   command-r-plus-104b (the parallel block) and internvl2-76b at 2 layers of
   full width; jamba-1.5-large-398b's 8-layer period (``ssd_scan`` and MoE)
   at its own width with int8 weights (``quantize_weights``: ~45 GB,
   dequantized one block position at a time; ``ARCH_SERVES`` says why each
   cut); then each one's float32 decode consistency, MoE at a capacity
   with no drops, internvl2 with vision embeds, jamba's at a cut width;
4. LM training: ``[train_kernels]`` holds the three backward kernels
   (rmsnorm's, flash_attention's and ssd_scan's) against their plain
   versions' autograd at the training shapes and times them beside
   ``scaled_dot_product_attention``'s and ``F.rms_norm``'s backward;
   ``[train]`` (this slice's main path) runs ``repro_torch.launch.train``
   at full width and depth in bf16 with remat, h2o-danube-1.8b at 4 x 8192
   tokens and mamba2-130m at 8 x 4096, 3 steps each, and checks the
   launches every step implies; ``[dryrun]`` dry-runs those two steps
   (``repro_torch.launch.dryrun`` on a 1x1 fake mesh, on the host) and holds
   their parameter, gradient and optimizer-state bytes equal to the card's,
   prints the predicted peak beside ``max_memory_allocated``, requires the
   roofline bound at ``launch/roofline.HW`` to be at or below the measured
   step wall and prints the step's ``roofline_fraction``, while a child
   process runs danube's step on a one-rank NCCL mesh with ``shard()``
   active (DTensor state, the pipeline's per-rank rows), bit for bit the
   unsharded step with equal launches; ``[train_witness]`` runs the launcher's
   steps on danube at full depth through the kernels and through the plain
   versions, from the same weights and batches, to tell a trajectory the
   model and optimizer make from one the kernels make;
   ``[train_parity]`` holds the card's train
   step against the port's CPU step at 2 full-width layers in float32,
   grad accumulation and remat against none, and a run resumed through an
   async checkpoint against the straight one;
5. the reference's remaining model options: ``[softcap]`` holds the
   capped instantiations of the four flash kernels (``softcap=50``, Gemma
   2's, on q and k scaled so that it bites) against the plain version and
   its autograd on both routes at danube's prefill and training shapes and
   at head dims 96 and 128, times them beside the uncapped kernels and
   ``flex_attention`` with a tanh score_mod, holds the uncapped bf16
   forward bit for bit against ``tools/flash_attention_sm90_uncapped.cu``
   (``tools/flash_fwd_bitwise.py``), then drives the capped kernels through
   danube's serve and two training steps and its float32 decode
   consistency with a cap of 1; ``[quantize]`` holds danube's int8 weights
   (``quantize_params``, full width and depth, float32) against its f32
   weights on the reference's bounds; ``[head_merge]`` holds musicgen's
   prefill with ``attn_head_merge`` bit for bit against the unmerged one.

Each path's kernel launch counters (and per-route counters) are zeroed just
before it and read just after it; every wall time is printed per phase, and
each redesign's design goals are printed as met or not met.

Lines it prints, in order: phase results, one JSON line
``{"kernels": [...]}``, the card's name and power limit as ``nvidia-smi``
reports them, and last ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero before the last line.  Without a CUDA device, or outside a
checkout (no ``src/repro_torch`` beside it), it exits non-zero and prints no
result.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# flash_attention's bf16 time at danube's prefill shape on the SIMT kernel,
# before the tensor-core kernel took bf16 (PERF.md section 6: chip_smoke.py
# on an NVIDIA H100 80GB HBM3 at 700 W)
FLASH_SIMT_BF16_MS = 31.708
# the bf16 flash backward's time at FLASH_BWD_CASES' two bf16 shapes on the
# SIMT kernels, before the tensor-core backward took bf16 (PERF.md section
# 6: chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W)
FLASH_BWD_SIMT_BF16_MS = (295.830, 104.927)

TOL = 1e-5
# The redesigns' goals on the card (design goals, printed as met or not):
# level_makespan at the search's shape (Inception-v3, B=320), device and
# host ms per launch;
LEVEL_GOAL_MS, LEVEL_HOST_GOAL_MS = 0.035, 0.025
# gcn_aggregate at the search's shape, device and host ms per launch;
GCN_GOAL_MS, GCN_HOST_GOAL_MS = 0.0059, 0.020
# rmsnorm at danube's prefill (18432x2560 bf16) and decode (4x2560 bf16)
# shapes, its device time above the bound over one main-path run, and its
# host ms per launch at the prefill shape (below the 0.0199 ms the same
# measurement gave before the redesign: PERF.md, NVIDIA H100 80GB HBM3 at
# 700 W).
RMS_PREFILL_GOAL_MS, RMS_DECODE_GOAL_MS = 0.0704, 0.003
RMS_EXCESS_GOAL_MS, RMS_HOST_BEFORE_MS = 10.0, 0.0199
# LM kernels against their plain versions (normwise): f32 as above; bf16 as
# the reference's own kernel tests (tests/test_kernels.py:14-15)
LM_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}
# prefill + decode against forward at full width in float32
CONSISTENCY_TOL = 1e-4
# the search-quality contract: the reference's best latencies over seeds
# (tools/reference_search_spread.py), the config both sides search with,
# and the one-sided Mann-Whitney p-value below which the port's search is
# worse than the reference's
SPREAD_JSON = os.path.join(ROOT, "tools", "reference_search_spread.json")
SPREAD_CONFIG = {"batch_chains": 16, "max_episodes": 3}
CONTRACT_P = 1e-3
# Table 13 (benchmarks/table13_topology.py): the reference's DP bounds and
# its device-head spread over seeds (tools/reference_topology_spread.py),
# the config of every search there but the seed, and the fleets whose
# spread the contract compares
TOPO_JSON = os.path.join(ROOT, "tools", "reference_topology_spread.json")
TOPO_CONFIG = {"num_devices": 4, "head": "device", "max_episodes": 12,
               "update_timestep": 10, "batch_chains": 8}
TOPO_CONTRACT = ("nvlink_island", "torus")
# Table 7 (benchmarks/table7_generalization.py): the joint trainer's config
# (the held-out runs take seed 1, as the benchmark's PRNGKey(1)), and the
# contract's config and record (tools/reference_multi_spread.py)
MULTI_CONFIG = {"num_devices": 2, "batch_chains": 8, "max_episodes": 12,
                "update_timestep": 10}
MULTI_JSON = os.path.join(ROOT, "tools", "reference_multi_spread.json")
MULTI_CONTRACT_CONFIG = dict(MULTI_CONFIG, max_episodes=3)
# Table 8 (benchmarks/table8_corpus.py): its full corpus, its held-out
# family, the trainer's config and arguments (the held-out runs take rng=1,
# as the benchmark's PRNGKey(1)), and the contract's config and records
# (tools/reference_corpus_spread.py [--full]): one over the full corpus, one
# over the corpus less its traced entry (its 14 pairs, kept)
CORPUS_FULL_SPEC = ("benchmark:names=inception_v3+resnet50;"
                    "traced:archs=qwen1.5-0.5b+phi3-mini-3.8b;"
                    "lm:archs=qwen1.5-0.5b+mamba2-130m:seq_len=1024;"
                    "synthetic:family=layered+series_parallel:count=6:"
                    "size=40:seed=0")
CORPUS_SPEC = ("benchmark:names=inception_v3+resnet50;"
               "lm:archs=qwen1.5-0.5b+mamba2-130m:seq_len=1024;"
               "synthetic:family=layered+series_parallel:count=6:size=40"
               ":seed=0")
CORPUS_FULL_JSON = os.path.join(ROOT, "tools",
                                "reference_corpus_spread_full.json")
HELD_OUT_SPEC = "synthetic:family=branch_join:count=2:size=40:seed=123"
CORPUS_CONFIG = {"num_devices": 2, "batch_chains": 8, "max_episodes": 12,
                 "update_timestep": 10}
CORPUS_TRAINER = {"max_buckets": 3, "graphs_per_episode": 4}
CORPUS_JSON = os.path.join(ROOT, "tools", "reference_corpus_spread.json")
CORPUS_CONTRACT_CONFIG = dict(CORPUS_CONFIG, max_episodes=3)
# the device head's fleet: two NVLink islands of four GPUs; the capacity
# phase gives the first island 128 MB a GPU and the second 0.04 of it
# (5.12 MB), which 8 of Inception-v3's nodes exceed
HEAD_FLEET = {"islands": 2, "gpus_per_island": 4}
CAPACITY_FLEET = dict(HEAD_FLEET, mem_capacity=128e6, island_scale=0.04)
# the main path's serves: (arch, batch, prompt, steps); phi3-mini's prompt
# and steps fill its 4096-position context
SERVES = (("h2o-danube-1.8b", 4, 4608, 32), ("mamba2-130m", 4, 4096, 32),
          ("phi3-mini-3.8b", 4, 4064, 32))
# the other six archs' serves, (arch, batch, prompt, steps, cut): olmoe-1b-7b
# (this slice's main path; prompt and steps fill its 4096-position context)
# and musicgen-medium at full width and depth; the others cut, as a
# dataclasses.replace of the registered config, to fit one card's 80 GB: at
# full depth mixtral, command-r and internvl2 hold 282, 208 and 140 GB of
# bf16 weights, so they run 2 layers at full width (mixtral's prompt past
# its 4096 window, so the ring buffer wraps); one 8-layer period of jamba
# at its own width holds ~90 GB in bf16 and ~45 GB in int8, so it serves
# one period (d_model 8192, 64 heads, kv 8, d_ff 24576) with
# quantize_weights=True
ARCH_SERVES = (
    ("olmoe-1b-7b", 4, 4064, 32, {}),
    ("musicgen-medium", 4, 2048, 32, {}),
    ("mixtral-8x22b", 4, 4608, 32, {"n_layers": 2}),
    ("command-r-plus-104b", 4, 4096, 32, {"n_layers": 2}),
    ("internvl2-76b", 4, 4096, 32, {"n_layers": 2}),
    ("jamba-1.5-large-398b", 4, 4096, 32,
     {"n_layers": 8, "quantize_weights": True}),
)
# the float32 decode consistency of an arch whose serve cut does not fit in
# f32: jamba's period at its own width is ~180 GB in f32, so its check runs
# the period at a cut width (its pattern, experts, SSM and head dims), ~12 GB
CONSISTENCY_CUTS = {"jamba-1.5-large-398b": {
    "n_layers": 8, "d_model": 2048, "n_heads": 16, "n_kv_heads": 2,
    "d_ff": 6144}}
# flash_attention at olmoe-1b-7b's prefill: (B, H, KV, S, D), causal
OLMOE_FLASH = (4, 16, 16, 4064, 128)
# the attention logit softcap: Gemma 2's published attn_logit_softcapping
# (50.0) for the capped kernels' agreement and timing, on q and k scaled by
# SOFTCAP_QK so that the cap bites (unit-normal q and k give scaled scores
# ~N(0, 1), where tanh(s/50) is linear to 1e-4 and a kernel that ignored the
# cap would pass); the capped forward at danube's prefill and at D = 96 and
# 128 causal, each route ((B, H, KV, S, D), window, dtype; f32 at batch 1),
# the backward at danube's training shape (f32 at batch 1)
SOFTCAP = 50.0
SOFTCAP_QK = 8.0
SOFTCAP_FWD_CASES = (((4, 32, 8, 4608, 80), 4096, "bfloat16"),
                     ((1, 32, 8, 4608, 80), 4096, "float32"),
                     ((4, 32, 32, 4064, 96), 0, "bfloat16"),
                     ((1, 32, 32, 4064, 96), 0, "float32"),
                     ((4, 16, 16, 4064, 128), 0, "bfloat16"),
                     ((1, 16, 16, 4064, 128), 0, "float32"))
SOFTCAP_BWD_CASES = (((4, 32, 8, 8192, 80), 4096, "bfloat16"),
                     ((1, 32, 8, 8192, 80), 4096, "float32"))
# the capped main paths: danube's serve (SERVES' batch, prompt, steps) and
# training steps at [train]'s batch and sequence, in bf16 with SOFTCAP; and
# danube's float32 decode consistency with a cap of 1, which its random
# weights' scaled scores (~N(0, 1)) pass often
SOFTCAP_TRAIN_STEPS = 2
SOFTCAP_CONSISTENCY = 1.0
# [quantize]: danube at full width and depth in float32, quantized against
# unquantized on the reference's own bounds (tests/test_quantize.py:41-57):
# (arch, B, S of the forwards, prompt and decode steps of the decode check)
QUANT = ("h2o-danube-1.8b", 2, 256, 200, 8)
QUANT_REL, QUANT_DECODE, QUANT_BYTES = 0.05, 2e-4, 2.5
# head merge: musicgen-medium's prefill (batch, prompt), merged against not
MERGE = ("musicgen-medium", 4, 2048)
# LM training (`[train]`): repro_torch.launch.train at full width and depth
# in bf16 with remat "full", (arch, global batch, seq, steps, ckpt every):
# danube's 32,768 tokens a step run past its 4096 window; its 22 GB state is
# not written (--ckpt-every 0), mamba2's is, every 2 steps and at the end
TRAINS = (("h2o-danube-1.8b", 4, 8192, 3, 0),
          ("mamba2-130m", 8, 4096, 3, 2))
# `[dryrun]`: each of TRAINS' steps dry-run (repro_torch.launch.dryrun) on a
# 1x1 fake mesh against the [train] run; then TRAINS[0]'s step for real on a
# one-rank NCCL mesh with shard() active, with DRYRUN_STEP_CUT applied to its
# config (nothing: full width and depth), bit for bit the unsharded step
DRYRUN_STEP_CUT = {}
# `[train_witness]`: danube at full width and depth in bf16, the launcher's
# optimizer, schedule and data, 3 steps through the kernels and the same 3
# through the plain versions on the card from the same weights and batches,
# at [train]'s sequence and window and one row of its batch (the plain
# attention of 4 rows would not fit); (arch, cut, B, S, steps)
WITNESS = ("h2o-danube-1.8b", {}, 1, 8192, 3)
# each step's loss and gradient norm, kernels against plain, relative
WITNESS_TOL = 1e-3
# the first batch's mean log-sum-exp against ln(vocab) + var/2, the expected
# log-sum-exp of iid normal logits of the measured variance
WITNESS_LSE_TOL = 0.05
# `[train_kernels]`: the backward kernels at the training shapes.  flash:
# danube's (B, H, KV, S, D, window) and a D=128 causal case without one,
# bf16; the f32 parity shape (below); rmsnorm: danube's and mamba2's
# (rows, d, dtype); ssd_scan: mamba2's (B, C, H, P, N) at chunk 32
FLASH_BWD_CASES = (((4, 32, 8, 8192, 80), 4096, "bfloat16"),
                   ((4, 16, 16, 4096, 128), 0, "bfloat16"),
                   ((2, 32, 8, 1024, 80), 256, "float32"))
RMS_BWD_CASES = ((4 * 8192, 2560, "bfloat16"), (8 * 4096, 768, "bfloat16"),
                 (8 * 4096, 1536, "float32"))
SSD_BWD_SHAPE = (8, 128, 24, 64, 128)
# `[train_parity]`: 2 layers of full width in float32 (the SMOKE configs'
# head dims, 8 for danube-smoke, are ones the flash kernel does not take),
# danube's window cut to 256 so that it binds at S=1024; (arch, cut, B, S)
PARITY = (("h2o-danube-1.8b", {"n_layers": 2, "dtype": "float32",
                               "sliding_window": 256, "remat": False},
           2, 1024),
          ("mamba2-130m", {"n_layers": 2, "dtype": "float32",
                           "remat": False}, 2, 1024))
# the card's f32 gradients against the CPU's, and grad_accum=2's against
# one batch, normwise per leaf: sums in another order over 2,048 tokens
# (tests/test_torch_train.py holds the CPU against the reference at the same
# bound)
PARITY_GRAD_TOL = 1e-4
# Table 2 (benchmarks/table2_placement.py through benchmarks/common.py): the
# learned baselines' config, the HSDAG row's (one search-mode session a
# graph, a host reward), the features every row takes, and the contract's
# baseline config and record (tools/reference_baseline_spread.py)
TABLE2_BASELINE = {"num_devices": 2, "episodes": 12,
                   "samples_per_episode": 10, "seed": 0}
TABLE2_HSDAG = {"num_devices": 2, "max_episodes": 12, "update_timestep": 10,
                "use_baseline": True, "normalize_weights": True, "seed": 0,
                "batch_chains": 1}
BASELINE_FEATURE = {"d_pos": 16}
BASELINE_JSON = os.path.join(ROOT, "tools", "reference_baseline_spread.json")
BASELINE_CONTRACT_CONFIG = {"num_devices": 2, "episodes": 3,
                            "samples_per_episode": 10}
# Table 4 (benchmarks/table4_downstream.py): BERT-base's final output under
# cpu_only and under the HSDAG placement, executed on the CPU and the card
# (f32, TF32 off, every accumulator started from TABLE4_FILL): normwise
# distance and the paper's cosine similarity
TABLE4_FILL = 1.0
TABLE4_TOL = 1e-4
TABLE4_CS = 0.999
# the stage planner's phi3-mini-3.8b plan (examples/placement_search.py)
PLAN = {"seq_len": 4096, "batch": 256, "num_stages": 2}
# the placement service at full width: a corpus policy over the three
# paper graphs and six synthetics, saved, loaded and served; each training
# graph three times in a shuffled stream
SERVICE_SPEC = "benchmark;synthetic:family=mixed:count=6:size=24:seed=0"
SERVICE_CONFIG = {"num_devices": 2, "batch_chains": 8, "max_episodes": 2,
                  "update_timestep": 10}
SERVICE_TRAINER = {"max_buckets": 3, "graphs_per_episode": 2}
SERVICE_KW = {"batch_slots": 4, "size_granularity": 16}
SERVICE_REPEATS = 3
# Tables 9 and 11 (benchmarks/table9_serving.py, table11_server.py) at
# benchmarks/common.py's defaults (REPRO_BENCH_EPISODES=12, timestep 10)
BENCH_EPISODES, BENCH_TIMESTEP = 12, 10
T9_TRAIN = "synthetic:family=mixed:count=6:size=24:seed=0"
T9_REQUESTS = 24
T11_TENANTS = {"a": ("synthetic:family=mixed:count=6:size=24:seed=0", 32),
               "b": ("synthetic:family=mixed:count=6:size=24:seed=1", 16)}
T11_REQUESTS = 100
SERVE_STREAM = ("synthetic:family=layered:count=3:size=12:seed=7;"
                "synthetic:family=layered:count=3:size=28:seed=8;"
                "synthetic:family=series_parallel:count=3:size=44:seed=9")
# the sharded corpus trainer (core/sim/sharded.py) at Table 8's width, 3
# episodes, trained at mesh_shape=(1, 1) under an NCCL group of one rank and
# unsharded, then at 1×1 with the episodic population under either replay
# weights, in a child process under deterministic algorithms
SHARDED_CONFIG = dict(CORPUS_CONFIG, hidden_channel=128, max_episodes=3)
# Table 10 (tools/port_table10.py): the card's throughput row at mesh 1×1
# (measured episodes after a warm-up run, in [sharded]'s child) and the
# memory rows at 24 graphs (the
# 240-graph rows take about a minute of tracemalloc on the host: the tool
# runs them)
TABLE10_EPISODES = 2
TABLE10_COUNTS = (24,)


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


def bound_ms(nbytes: float, ops: float, peak: str = "peak_flops_f32"):
    """The least time for ``nbytes`` moved and ``ops`` done (float32
    outside the tensor cores by default) at the H100 SXM's published rates
    (``repro_torch.launch.roofline.HW``) → (ms, what binds)."""
    from repro_torch.launch.roofline import HW
    t_bytes = nbytes / HW["hbm_bw"] * 1e3
    t_ops = ops / HW[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(torch, got, want) -> float:
    """max |got − want| / max |want| (normwise relative error)."""
    scale = want.abs().max().clamp_min(1e-30)
    return float((got - want).abs().max() / scale)


def wide_dag(seed, layers, width, fan_in, params):
    """A layered DAG wider than a warp: ``layers`` levels of ``width`` ops,
    each op after the first level fed by ``fan_in`` distinct earlier ops (one
    of them in the level before) and ``params`` weight ops ("data"), with
    its inputs in random order, so data predecessors sit between real ones.
    """
    import numpy as np
    from repro_torch.core.graph import CompGraph
    rng = np.random.default_rng(seed)
    types = ["MatMul", "ReLU", "Concat", "Convolution", "Add"]
    g = CompGraph(f"wide{layers}x{width}")
    ids = []
    for k in range(layers):
        ids.append([g.add_op(f"n{k}_{i}", types[int(rng.integers(5))],
                             output_shape=(1, 8),
                             flops=float(rng.integers(1, 10 ** 6)),
                             bytes_out=float(rng.integers(4, 4096)))
                    for i in range(width)])
    for k in range(1, layers):
        earlier = np.concatenate(ids[:k])
        for v in ids[k]:
            srcs = {int(rng.choice(ids[k - 1]))}
            while len(srcs) < min(fan_in, len(earlier)):
                srcs.add(int(rng.choice(earlier)))
            srcs = list(srcs) + [
                g.add_op(f"w{v}_{i}", "Parameter", output_shape=(1, 8),
                         bytes_out=float(rng.integers(4, 4096)))
                for i in range(params)]
            rng.shuffle(srcs)
            for u in srcs:
                g.add_edge(int(u), v)
    return g


def four_devices():
    """A 4-device platform with non-uniform links and 1-3 queues a device
    (D·Q = 12: the kernel's shared-memory queues)."""
    import math
    import numpy as np
    from repro_torch.core import DeviceSpec, Platform
    devs = tuple(DeviceSpec(f"d{i}", "gpu", peak_flops=(1 + i) * 4e12,
                          mem_bw=(2 + i) * 1e11, dispatch_overhead=2e-6,
                          parallel_queues=1 + i % 3) for i in range(4))
    bw = np.full((4, 4), 20e9)
    bw[0, 1] = bw[1, 0] = 300e9
    np.fill_diagonal(bw, math.inf)
    lat = np.full((4, 4), 5e-6)
    np.fill_diagonal(lat, 0.0)
    return Platform(devs, bw, lat)


def level_build_report():
    """level_makespan's instances as built: registers, spills and shared
    memory from nvcc's ``-Xptxas -v`` log, for the instances the checks run
    (queues in registers at D=2, Q=4; in shared memory; the general
    route)."""
    import re
    from repro_torch.kernels._build import _lib_path
    log = _lib_path("levelsim").with_suffix(".log").read_text()
    name = {"2,4,1": "staged, registers D=2 Q=4",
            "8,1,1": "staged, registers D=8 Q=1",
            "0,0,1": "staged, shared queues",
            "0,0,0": "general"}
    key = None
    for line in log.splitlines():
        entry = re.search(r"level_makespan_kernelILi(\d+)ELi(\d+)ELb([01])E",
                          line)
        if entry and "Compiling entry" in line:
            key = ",".join(entry.groups())
        elif key in name and ("registers" in line or "spill" in line
                              or "smem" in line):
            print(f"[build] level_makespan {name[key]}: {line.strip()}")


def makespan_checks(torch, label, backend, cases, timed, required):
    """level_makespan against level_makespan_ref on ``backend``'s tables
    (the level tables, or the scan backend's chain tables), bitwise (max
    abs err 0), for each (graph, platform, B) of ``cases``; each case prints
    its plan and checks that it took the plan's route with the shared
    memory the kernel computes.  Every route of ``required`` must have run.
    Then device and host time per launch for each (graph, platform, B) of
    ``timed``, the first of which is the one reported; → (worst max abs
    err, (ms, plain ms, bound ms, bound by) of the reported case)."""
    import ctypes
    from repro_torch.kernels import level_makespan, level_makespan_ref
    from repro_torch.kernels._build import library
    from repro_torch.kernels.levelsim import ROUTES, level_launch_plan
    smem_of = library("levelsim").level_makespan_smem
    smem_of.restype = ctypes.c_longlong
    smem_of.argtypes = [ctypes.c_int] * 7
    gen = torch.Generator(device="cuda").manual_seed(0)

    def setup(g, pf, B):
        prep = backend.prepare(g, pf)
        sim, lt = prep.sim, prep.tables
        L, W, P, D = lt.shape
        V, Q = lt.num_nodes, sim["queue_init"].shape[1]
        place = torch.randint(0, D, (B, V), generator=gen, device="cuda",
                              dtype=torch.int32)
        args = (lt, place, sim["queue_init"], sim["inv_bw"], sim["lat"])
        return lt, args, level_launch_plan(B, L, W, P, V, D, Q, lt.slots)

    worst = 0.0
    per_route = dict.fromkeys(ROUTES, 0)
    for g, pf, B in cases:
        lt, args, plan = setup(g, pf, B)
        L, W, P, D = lt.shape
        V, Q = lt.num_nodes, args[2].shape[1]
        check(smem_of(ROUTES.index(plan.route), plan.per_block, V, D, Q,
                      lt.slots, lt.offsets[-1]) == plan.smem,
              f"level_launch_plan's shared memory {plan.smem} B is not the "
              f"kernel's for {label} {g.name} B={B}")
        before = level_makespan.route_launches[plan.route]
        fk, tk = level_makespan(*args)
        check(level_makespan.route_launches[plan.route] == before + 1,
              f"{label} {g.name} B={B} did not take {plan.route}")
        per_route[plan.route] += 1
        fr, tr = level_makespan_ref(*args)
        torch.cuda.synchronize()
        abs_err = float(max((fk - fr).abs().max(), (tk - tr).abs().max()))
        worst = max(worst, abs_err)
        print(f"[kernels] {label}[{plan.route}] {g.name} D={D} Q={Q}: "
              f"B={B} V={V} L={L} W={W} P={P} S={lt.slots}; {plan.group} "
              f"lanes a placement, {plan.per_block} placements and "
              f"{plan.warps} warps a block, {plan.blocks} blocks, "
              f"{plan.smem} B shared, queues in {plan.queues}; max abs err "
              f"{abs_err:.3e}")
        check(abs_err == 0.0 and torch.equal(fk, fr) and torch.equal(tk, tr),
              f"{label} is not bitwise its plain version on {g.name} B={B} "
              f"D={D}")
        del args, fk, tk, fr, tr
    print(f"[kernels] {label} cases per route: {per_route}")
    check(all(per_route[r] for r in required),
          f"the {label} checks left a route unrun: {per_route}")
    timing = None
    for g, pf, B in timed:
        lt, args, plan = setup(g, pf, B)
        L, W, P, D = lt.shape
        V, Q = lt.num_nodes, args[2].shape[1]
        ms, host = cuda_ms(torch, lambda: level_makespan(*args), 200)
        n_preds = int((lt.pred_data == 0).sum())
        nbytes = 4 * (lt.offsets[-1] + B * V + 2 * D * D + D * Q
                      + B * (V + 1) + B)
        ops = B * (5 * n_preds + lt.slots * (Q + 2))
        bound, by = bound_ms(nbytes, ops)
        print(f"[kernels] {label} timing {g.name} B={B} ({plan.route}, "
              f"{plan.group} lanes a placement, {plan.per_block} placements "
              f"and {plan.warps} warps a block, {plan.blocks} blocks, "
              f"{plan.smem} B shared): kernel {ms:.5f} ms on the card "
              f"({host:.5f} ms of host time to launch), "
              f"{B / ms * 1e3:.6g} placements/s; chain {L} rows of {W}, "
              f"{lt.slots} real slots, {ms / L * 1e3:.4f} us a row; bound "
              f"{bound:.6f} ms ({by}: {nbytes} B, {ops} ops)")
        if timing is None:
            plain, _ = cuda_ms(torch, lambda: level_makespan_ref(*args), 2, 1)
            timing = (ms, plain, bound, by, host)
            print(f"[kernels] {label} {g.name} B={B}: plain {plain:.3f} ms")
        del args
    return worst, timing


def eight_gpus(queues=1):
    """The device head's fleet, ``nvlink_island(2, 4)``: D=8, with
    ``queues`` queues a device (D·Q = 8: queues in registers; 16: in
    shared memory)."""
    from repro_torch.platforms import nvlink_island
    return nvlink_island(**HEAD_FLEET, parallel_queues=queues)


def level_checks(torch, graphs, plat):
    """The level backend's tables: the three paper graphs at B = 1, 7 (a
    ragged last warp), 320 (the search's window) and 4096 (a full card), a
    DAG wider than a warp with 9 real predecessors a node, the four-device
    platform (queues in shared memory), Inception-v3 on the eight-GPU fleet
    at B = 16 and 320 with one queue a device (queues in registers, D=8
    Q=1) and two (in shared memory), and a DAG whose tables do not fit
    shared memory (the general route); timed at B=320 on the three paper
    graphs, at B=4096 on Inception-v3 and at B=320 on the eight GPUs."""
    from repro_torch.core.sim import LevelBackend
    from repro_torch.kernels.levelsim import ROUTES
    four = four_devices()
    wide = wide_dag(1, 5, 40, 9, 2)
    big = wide_dag(2, 60, 64, 8, 0)
    inc = graphs["inception_v3"]
    cases = [(g, plat, B) for g in graphs.values() for B in (1, 7, 320, 4096)]
    cases += [(wide, plat, 7), (wide, plat, 320), (wide, four, 7),
              (wide, four, 320), (inc, four, 7), (inc, four, 320),
              (big, plat, 7)]
    cases += [(inc, eight_gpus(q), B) for q in (1, 2) for B in (16, 320)]
    timed = [(inc, plat, 320)]
    timed += [(graphs[n], plat, 320) for n in ("resnet50", "bert_base")]
    timed += [(inc, plat, 4096), (inc, eight_gpus(), 320)]
    worst, timing = makespan_checks(torch, "level_makespan",
                                    LevelBackend(device="cuda"), cases,
                                    timed, required=ROUTES)
    ms, host = timing[0], timing[4]
    print(f"[kernels] level_makespan inception_v3 B=320: design goals: "
          f"device <= {LEVEL_GOAL_MS} ms "
          f"{'met' if ms <= LEVEL_GOAL_MS else 'not met'}, host <= "
          f"{LEVEL_HOST_GOAL_MS} ms "
          f"{'met' if host <= LEVEL_HOST_GOAL_MS else 'not met'}")
    return worst, timing[:4]


def scan_checks(torch, graphs, plat):
    """The scan backend: level_makespan on chain tables (one non-data node
    a row, heap-Kahn order; every case on the staged route, one lane a
    placement) bitwise against its plain version on the three paper graphs
    at B = 1, 7, 80 (a joint-training window), 320 and 4096, on the
    four-device platform, on the
    eight-GPU fleet and on the W=40 DAG; the backend against the host
    scheduler in its default (topo) order
    at 1e-5; then device and host time at B=320 on the three paper graphs
    and at B=4096 on Inception-v3."""
    import numpy as np
    from repro_torch.core import simulate
    from repro_torch.core.sim import ScanBackend
    backend = ScanBackend(device="cuda")
    four = four_devices()
    wide = wide_dag(1, 5, 40, 9, 2)
    # B=80: a joint-training window of one graph (T=10 × 8 chains)
    cases = [(g, plat, B) for g in graphs.values()
             for B in (1, 7, 80, 320, 4096)]
    cases += [(wide, plat, 7), (wide, plat, 320), (wide, four, 7),
              (wide, four, 320), (graphs["inception_v3"], four, 7),
              (graphs["inception_v3"], four, 320),
              (graphs["inception_v3"], eight_gpus(), 320)]
    timed = [(graphs["inception_v3"], plat, 320)]
    timed += [(graphs[n], plat, 320) for n in ("resnet50", "bert_base")]
    timed += [(graphs["inception_v3"], plat, 4096)]
    worst, timing = makespan_checks(torch, "node_scan", backend, cases,
                                    timed, required=("staged",))
    rng = np.random.default_rng(0)
    for g, pf in [(g, plat) for g in graphs.values()] + [
            (wide, four), (graphs["inception_v3"], four),
            (graphs["inception_v3"], eight_gpus())]:
        placements = rng.integers(0, pf.num_devices, (8, g.num_nodes))
        res = backend.simulate_batch(backend.prepare(g, pf), placements)
        host = np.array([simulate(g, p, pf).latency for p in placements])
        err = float(np.max(np.abs(res.latency - host) / host))
        print(f"[kernels] node_scan backend {g.name} D={pf.num_devices}: 8 "
              f"placements, latency rel err vs the host scheduler (topo "
              f"order) {err:.3e}")
        check(err <= TOL, f"the scan backend disagrees with the host "
                          f"scheduler on {g.name}")
    return worst, timing[:4]


def gcn_checks(torch, graphs):
    """gcn_aggregate forward and backward against its plain version on the
    three paper graphs at F = 37 (the scalar route), 128 and 200 (the
    float4 route, 200 with a ragged second pass) and B = 1, 8 (the joint
    trainer's chains) and 16, each case checking the route it took; then its time at the search's
    shape (Inception-v3, B=16, F=128) beside the plain version and a dense
    ``torch.bmm``."""
    from repro_torch.core.gnn import normalize_adjacency
    from repro_torch.kernels import (GCNAggregate, gcn_aggregate,
                                     gcn_aggregate_ref, gcn_graph)
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    timing = None
    for name, g in graphs.items():
        V, E = g.num_nodes, g.num_edges
        graph = gcn_graph(g.edges, V, "cuda")
        for B in (1, 8, 16):
            keep = (torch.rand(B, E, generator=gen, device="cuda")
                    < 0.8).float()
            for F in (37, 128, 200):
                h = torch.randn(B, V, F, generator=gen, device="cuda")
                gout = torch.randn(B, V, F, generator=gen, device="cuda")
                route = "vec4" if F % 4 == 0 else "scalar"
                before = gcn_aggregate.route_launches[route]
                out_k = gcn_aggregate(graph, keep, h)
                out_r = gcn_aggregate_ref(graph, keep, h)
                hk = h.clone().requires_grad_(True)
                (gk,) = torch.autograd.grad(
                    GCNAggregate.apply(graph, keep, hk), hk, gout)
                hr = h.clone().requires_grad_(True)
                (gr,) = torch.autograd.grad(
                    gcn_aggregate_ref(graph, keep, hr), hr, gout)
                torch.cuda.synchronize()
                # the call, GCNAggregate's forward and its backward
                check(gcn_aggregate.route_launches[route] == before + 3,
                      f"gcn_aggregate {name} F={F} did not take the {route} "
                      f"route forward and backward")
                e_f, e_b = rel_err(torch, out_k, out_r), rel_err(torch, gk,
                                                                 gr)
                abs_err = float(max((out_k - out_r).abs().max(),
                                    (gk - gr).abs().max()))
                worst = max(worst, abs_err)
                print(f"[kernels] gcn_aggregate[{route}] {name}: B={B} "
                      f"V={V} E={E} F={F} forward rel err {e_f:.3e}, "
                      f"backward rel err {e_b:.3e}, max abs err "
                      f"{abs_err:.3e}")
                check(e_f <= TOL and e_b <= TOL,
                      f"gcn_aggregate disagrees with its plain version on "
                      f"{name} B={B} F={F}")
        if name == "inception_v3":
            B, F = 16, 128
            keep = (torch.rand(B, E, generator=gen, device="cuda")
                    < 0.8).float()
            h = torch.randn(B, V, F, generator=gen, device="cuda")
            out_r = gcn_aggregate_ref(graph, keep, h)
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
                  f"F={F}: kernel {ms:.5f} ms on the card ({host:.5f} ms of "
                  f"host time to launch), plain {plain:.4f} ms, "
                  f"torch.bmm(dense Â, H) {lib:.4f} ms (rel err vs plain "
                  f"{lib_err:.2e}), bound {timing[2]:.6f} ms ({timing[3]}: "
                  f"{nbytes} B, {ops} ops; the bytes stay in the 50 MB L2 "
                  f"between calls); design goals: device <= "
                  f"{GCN_GOAL_MS} ms "
                  f"{'met' if ms <= GCN_GOAL_MS else 'not met'}, host <= "
                  f"{GCN_HOST_GOAL_MS} ms "
                  f"{'met' if host <= GCN_HOST_GOAL_MS else 'not met'}")
    return worst, timing


def sage_checks(torch, graphs):
    """sage_aggregate forward and backward (``SageAggregate``: the
    transpose, each neighbour's term over its degree) against its plain
    version, the reference's dense formula per chain, on the three paper
    graphs at F = 37, 128, 200 and B = 1, 16; then its time at the SAGE
    search's shape (Inception-v3, B=16, F=128) beside the plain version and
    one ``torch.bmm`` on the dense per-chain operator D⁻¹S."""
    from repro_torch.kernels import (SageAggregate, gcn_graph,
                                     sage_aggregate, sage_aggregate_ref)
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    timing = None
    for name, g in graphs.items():
        V, E = g.num_nodes, g.num_edges
        graph = gcn_graph(g.edges, V, "cuda")
        for B in (1, 8, 16):
            keep = (torch.rand(B, E, generator=gen, device="cuda")
                    < 0.8).float()
            for F in (37, 128, 200):
                h = torch.randn(B, V, F, generator=gen, device="cuda")
                gout = torch.randn(B, V, F, generator=gen, device="cuda")
                before = sage_aggregate.launches
                out_k = sage_aggregate(graph, keep, h)
                out_r = sage_aggregate_ref(graph, keep, h)
                hk = h.clone().requires_grad_(True)
                (gk,) = torch.autograd.grad(
                    SageAggregate.apply(graph, keep, hk), hk, gout)
                hr = h.clone().requires_grad_(True)
                (gr,) = torch.autograd.grad(
                    sage_aggregate_ref(graph, keep, hr), hr, gout)
                torch.cuda.synchronize()
                check(sage_aggregate.launches == before + 3,
                      f"sage_aggregate {name} F={F} did not launch its "
                      f"kernel forward and backward")
                e_f, e_b = rel_err(torch, out_k, out_r), rel_err(torch, gk,
                                                                 gr)
                abs_err = float(max((out_k - out_r).abs().max(),
                                    (gk - gr).abs().max()))
                worst = max(worst, abs_err)
                print(f"[kernels] sage_aggregate {name}: B={B} V={V} E={E} "
                      f"F={F} forward rel err {e_f:.3e}, backward rel err "
                      f"{e_b:.3e}, max abs err {abs_err:.3e}")
                check(e_f <= TOL and e_b <= TOL,
                      f"sage_aggregate disagrees with its plain version on "
                      f"{name} B={B} F={F}")
        if name == "inception_v3":
            B, F = 16, 128
            keep = (torch.rand(B, E, generator=gen, device="cuda")
                    < 0.8).float()
            h = torch.randn(B, V, F, generator=gen, device="cuda")
            out_r = sage_aggregate_ref(graph, keep, h)
            adj = torch.zeros(B, V, V, device="cuda")
            bidx = torch.arange(B, device="cuda")[:, None]
            adj[bidx, graph.src[None], graph.dst[None]] = keep
            deg = torch.clamp(adj.sum(1) + adj.sum(2), min=1.0)
            op = (adj + adj.transpose(1, 2)) / deg[..., None]
            lib_err = rel_err(torch, torch.bmm(op, h), out_r)
            ms, host = cuda_ms(torch, lambda: sage_aggregate(graph, keep, h),
                               100)
            plain, _ = cuda_ms(torch,
                               lambda: sage_aggregate_ref(graph, keep, h), 50)
            lib, _ = cuda_ms(torch, lambda: torch.bmm(op, h), 100)
            # h read once, out written once, the keep mask, rowptr and the
            # 2E CSR records (16 B) with their edge ids
            nbytes = 4 * (2 * B * V * F + B * E + (V + 1) + 2 * E * 5)
            # a multiply and an add per entry and feature, the degree sums,
            # a divide per output
            ops = B * F * 2 * (2 * E) + B * 2 * E + B * V * F
            timing = (ms, plain, *bound_ms(nbytes, ops), lib)
            print(f"[kernels] sage_aggregate timing at inception_v3, B={B}, "
                  f"F={F}: kernel {ms:.5f} ms on the card ({host:.5f} ms of "
                  f"host time to launch), plain (dense formula) "
                  f"{plain:.4f} ms, torch.bmm(dense D^-1 S, H) {lib:.4f} ms "
                  f"(rel err vs plain {lib_err:.2e}), bound "
                  f"{timing[2]:.6f} ms ({timing[3]}: {nbytes} B, {ops} ops)")
    return worst, timing


def bound_ms_bf16(nbytes: float, ops: float):
    """As ``bound_ms`` for work on the bf16 tensor cores."""
    return bound_ms(nbytes, ops, "peak_flops")


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


def rmsnorm_route_sweep(torch, gen, worst):
    """rmsnorm against rmsnorm_ref at rows {1, 4, 5, 18432} x d {37, 200,
    768, 1536, 2560, 8192} in f32 and bf16, at mamba2's prefill rows, and
    with x and scale off a 16-byte boundary, each case checking that it took
    the route ``rmsnorm_launch_plan`` gives; → (worst max abs error,
    cases per route)."""
    from repro_torch.kernels import rmsnorm, rmsnorm_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_launch_plan
    cases = [(rows, d, dtype, 0)
             for rows in (1, 4, 5, 18432)
             for d in (37, 200, 768, 1536, 2560, 8192)
             for dtype in (torch.float32, torch.bfloat16)]
    # mamba2's prefill norms at their own row count
    cases += [(4 * 4096, d, dtype, 0) for d in (768, 1536)
              for dtype in (torch.float32, torch.bfloat16)]
    # one element past the allocation's start: no longer 16-byte aligned
    cases += [(rows, 2560, dtype, 1) for rows in (4, 18432)
              for dtype in (torch.float32, torch.bfloat16)]
    per_route = dict.fromkeys(rmsnorm.route_launches, 0)
    for rows, d, dtype, skew in cases:
        buf = torch.randn(rows * d + skew, generator=gen, device="cuda")
        x = buf.to(dtype)[skew:].view(rows, d)
        sbuf = torch.randn(d + skew, generator=gen, device="cuda") + 1.0
        scale = sbuf[skew:]
        plan = rmsnorm_launch_plan(rows, d, dtype, skew == 0)
        before = rmsnorm.route_launches[plan.route]
        got = rmsnorm(x, scale)
        check(rmsnorm.route_launches[plan.route] == before + 1,
              f"rmsnorm {rows}x{d} {dtype} did not take {plan.route}")
        per_route[plan.route] += 1
        worst = lm_check(torch, f"rmsnorm[{plan.route} x{plan.per_thread}"
                         f"] {rows}x{d} {dtype}"
                         + (" unaligned" if skew else ""), got,
                         rmsnorm_ref(x, scale), dtype, worst)
        del buf, x, got
    check(all(per_route.values()),
          f"the rmsnorm sweep left a route unrun: {per_route}")
    return worst, per_route


def rmsnorm_checks(torch):
    """rmsnorm on every route (``rmsnorm_route_sweep``); then at the main
    path's shapes: its time at danube's prefill (4·4608 × 2560 bf16) beside
    the plain version and ``F.rms_norm``, and at every shape the serves
    launch it at (decode's 4-row norms included) its device and host time
    beside ``F.rms_norm``'s, summed above its bound over one main-path
    run."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm, rmsnorm_ref, rmsnorm_work
    from repro_torch.kernels.rmsnorm import rmsnorm_launch_plan
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, per_route = rmsnorm_route_sweep(torch, gen, 0.0)
    print(f"[lm-kernels] rmsnorm route sweep: cases per route {per_route}")
    rows, d = 4 * 4608, 2560
    x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    scale = torch.randn(d, generator=gen, device="cuda") + 1.0
    ms, host = cuda_ms(torch, lambda: rmsnorm(x, scale), 50)
    plain, _ = cuda_ms(torch, lambda: rmsnorm_ref(x, scale), 20)
    # the library call takes the weight in x's dtype: a yardstick of speed
    w16 = scale.bfloat16()
    lib, _ = cuda_ms(torch, lambda: F.rms_norm(x, (d,), w16, 1e-6), 50)
    ops, nbytes = rmsnorm_work(rows, d, x.dtype)
    t = (ms, plain, *bound_ms(nbytes, ops), lib)
    print(f"[lm-kernels] rmsnorm timing {rows}x{d} bf16: kernel {ms:.4f} ms "
          f"on the card ({host:.4f} ms of host time to launch), plain "
          f"{plain:.4f} ms, F.rms_norm {lib:.4f} ms, bound {t[2]:.6f} ms "
          f"({t[3]}: {nbytes} B, {ops} ops), {100 * t[2] / ms:.1f} % of the "
          f"bound; design goals: <= {RMS_PREFILL_GOAL_MS} ms and no slower "
          f"than F.rms_norm "
          f"{'met' if ms <= min(RMS_PREFILL_GOAL_MS, lib) else 'not met'}, "
          f"host time below the {RMS_HOST_BEFORE_MS} ms this measurement "
          f"gave before the redesign "
          f"{'met' if host < RMS_HOST_BEFORE_MS else 'not met'}")

    # every serve shape: device and host time beside F.rms_norm, and the
    # device time above the bound summed over the serves' launches
    shapes = rmsnorm_serve_shapes(torch)
    excess, hosts, slower = 0.0, [], []
    for arch, rows, d, dtype, n in shapes:
        x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        scale = torch.randn(d, generator=gen, device="cuda") + 1.0
        w = scale.to(dtype)
        iters = 50 if rows > 64 else 500
        ms_s, host_s = cuda_ms(torch, lambda: rmsnorm(x, scale), iters)
        lib_s, _ = cuda_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-6),
                           iters)
        ops, nbytes = rmsnorm_work(rows, d, x.dtype)
        b_ms, _ = bound_ms(nbytes, ops)
        excess += n * max(ms_s - b_ms, 0.0)
        hosts.append(host_s)
        if ms_s > lib_s:
            slower.append(f"{rows}x{d} {dtype}")
        route = rmsnorm_launch_plan(rows, d, dtype).route
        print(f"[lm-kernels] rmsnorm {arch} {rows}x{d} {dtype} ({route}): "
              f"{n} launches per main-path run, kernel {ms_s:.5f} ms "
              f"({host_s:.5f} ms of host time to launch), F.rms_norm "
              f"{lib_s:.5f} ms, bound {b_ms:.6f} ms, above the bound "
              f"{n * (ms_s - b_ms):.4f} ms")
        if (rows, d, dtype) == (4, 2560, torch.bfloat16):
            print(f"[lm-kernels] rmsnorm decode 4x2560 bf16: design goal <= "
                  f"{RMS_DECODE_GOAL_MS} ms: "
                  f"{'met' if ms_s <= RMS_DECODE_GOAL_MS else 'not met'}")
    print(f"[lm-kernels] rmsnorm device time above its bound over one "
          f"main-path run: {excess:.4f} ms (design goal <= "
          f"{RMS_EXCESS_GOAL_MS} ms: "
          f"{'met' if excess <= RMS_EXCESS_GOAL_MS else 'not met'}); no "
          f"slower than F.rms_norm at every serve shape: "
          f"{'met' if not slower else 'not met, slower at ' + ', '.join(slower)}"
          f"; host time per launch {min(hosts):.5f}-{max(hosts):.5f} ms at "
          f"these shapes")
    return worst, t, shapes


def flash_sm90_report():
    """The bf16 tensor-core flash kernels' build (the forward and the
    backward's dq and dk/dv kernels, uncapped and capped): per head dim,
    registers and spills from nvcc's ``-Xptxas -v`` log and the dynamic
    shared memory a block takes."""
    import ctypes
    import re
    from repro_torch.kernels._build import _lib_path, library
    smem = library("flash_attention_sm90").flash_attention_bf16_sm90_smem
    smem.restype, smem.argtypes = ctypes.c_int, [ctypes.c_int]
    bwd_smem = library("flash_attention_bwd_sm90") \
        .flash_attention_bwd_bf16_sm90_smem
    bwd_smem.restype = ctypes.c_int
    bwd_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    kernels = {"flash_attention_sm90_kernel": lambda d: smem(d),
               "flash_bwd_dq_sm90": lambda d: bwd_smem(d, 0),
               "flash_bwd_dkv_sm90": lambda d: bwd_smem(d, 1)}
    for lib in ("flash_attention_sm90", "flash_attention_bwd_sm90"):
        log = _lib_path(lib).with_suffix(".log").read_text()
        name = d = cap = None
        for line in log.splitlines():
            # the kernel's own name, not the anonymous namespace's, which
            # holds the file name ("..._flash_attention_sm90_cu_...")
            entry = re.search(r"(" + "|".join(kernels)
                              + r")ILi(\d+)ELb([01])E", line)
            if entry and "Compiling entry" in line:
                name, d = entry.group(1), int(entry.group(2))
                cap = " softcap" if entry.group(3) == "1" else ""
            elif d is not None and ("registers" in line or "spill" in line):
                print(f"[build] {name} D={d}{cap}: {line.strip()}"
                      + (f"; dynamic shared memory {kernels[name](d)} B per "
                         f"block" if "registers" in line else ""))


def flash_checks(torch):
    """flash_attention on both routes, each case against
    ``flash_attention_ref``: bf16 through the tensor-core kernel
    (``csrc/flash_attention_sm90.cu``) at danube's prefill shape (B=4, H=32,
    KV=8, S=4608, D=80, window 4096) and at D=64/80/128 with GQA, MHA, a
    window edge inside a tile, a ragged S and causal=False; f32 through the
    SIMT kernel (``csrc/flash_attention.cu``) at batch 1 of danube's shape and
    the small cases; both at phi3-mini's head dim 96 (its prefill, B=4,
    H=KV=32, S=4064, in bf16, at batch 1 in f32).  Then the bf16 kernel's
    time beside ``scaled_dot_product_attention`` on the same inputs at both
    prefill shapes, and at olmoe-1b-7b's (B=4, H=KV=16, S=4064, D=128) →
    (worst at head dims 64/80/128, danube's timing, worst at head dim 96,
    phi3-mini's timing, worst at olmoe's shape, olmoe's timing)."""
    import torch.nn.functional as F
    from repro_torch.kernels import (flash_attention, flash_attention_ref,
                                     flash_attention_work, flash_pairs)
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

    worst = {False: 0.0, True: 0.0}     # by "the head dim is 96"
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
             ((1, 4, 1, 333, 128), False, 0, bf16),
             # phi3-mini's head dim 96: its prefill at batch 1 in f32, and
             # the tensor-core kernel's 32-column tail slab
             ((1, 32, 32, 4064, 96), True, 0, f32),
             ((1, 4, 2, 300, 96), False, 64, f32),
             ((2, 8, 8, 700, 96), True, 256, bf16),
             ((1, 8, 2, 333, 96), True, 100, bf16),
             ((1, 4, 2, 300, 96), False, 64, bf16)]
    for shape, causal, window, dtype in cases:
        q, k, v = qkv(*shape, dtype)
        before = dict(flash_attention.route_launches)
        got = flash_attention(q, k, v, causal=causal, window=window)
        route = routes[dtype]
        check(flash_attention.route_launches[route] == before[route] + 1,
              f"flash_attention {shape} {dtype} did not take the {route} "
              f"kernel")
        d96 = shape[4] == 96
        worst[d96] = lm_check(
            torch, f"flash_attention[{route}] {shape} causal={causal} "
            f"window={window} {dtype}", got,
            flash_attention_ref(q, k, v, causal=causal, window=window),
            dtype, worst[d96])
        del q, k, v, got
    def timing(B, H, KV, S, D, W, worst):
        """The bf16 kernel at a prefill shape against the plain version,
        then its time beside scaled_dot_product_attention's and the
        plain version's → (worst, (ms, plain, bound, bound_by, library))."""
        q, k, v = qkv(B, H, KV, S, D, bf16)
        got = flash_attention(q, k, v, window=W)
        want = flash_attention_ref(q, k, v, window=W)
        worst = lm_check(torch, f"flash_attention[wgmma_bf16] "
                         f"{(B, H, KV, S, D)} causal=True window={W} bf16",
                         got, want, bf16, worst)
        mask = flash_mask(S, True, W, "cuda")
        if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
        else:   # torch < 2.5: the same call on K/V repeated to H heads
            k_h = k.repeat_interleave(H // KV, dim=1)
            v_h = v.repeat_interleave(H // KV, dim=1)

            def library():
                return F.scaled_dot_product_attention(q, k_h, v_h,
                                                      attn_mask=mask)
        lib_out = library()
        lib_err = rel_err(torch, lib_out.float(), want.float())
        del got, want, lib_out
        ms, host = cuda_ms(torch, lambda: flash_attention(q, k, v, window=W),
                           20)
        lib, _ = cuda_ms(torch, library, 10)
        ms2, _ = cuda_ms(torch, lambda: flash_attention(q, k, v, window=W),
                         20)
        plain, _ = cuda_ms(torch,
                           lambda: flash_attention_ref(q, k, v, window=W),
                           2, 1)
        # the pair count comes from the kernel's own tile plan
        pairs, visited = flash_pairs(S, True, W)
        check(pairs == int(mask.sum()), "flash_pairs disagrees with the mask")
        ops, nbytes = flash_attention_work(B, H, KV, S, D, q.dtype,
                                           window=W)
        check(ops == 4 * B * H * D * pairs,
              "flash_attention_work disagrees with flash_pairs")
        t = (min(ms, ms2), plain, *bound_ms_bf16(nbytes, ops), lib)
        print(f"[lm-kernels] flash_attention timing {(B, H, KV, S, D)} "
              f"window {W} bf16: tensor-core kernel {ms:.4f} / {ms2:.4f} ms "
              f"on the card (two runs around the library's; {host:.4f} ms "
              f"of host time to launch), "
              f"{ops / (t[0] * 1e-3) / 1e12:.1f} TFLOP/s on the unmasked "
              f"pairs, {100 * t[2] / t[0]:.1f} % of the bound; "
              f"scaled_dot_product_attention(mask, enable_gqa) {lib:.4f} ms "
              f"(rel err vs plain {lib_err:.2e}); plain {plain:.3f} ms; "
              f"bound {t[2]:.6f} ms ({t[3]}: {nbytes} B, {ops} ops over "
              f"{pairs} unmasked (query, key) pairs per head; the visited "
              f"tiles hold {visited}); design goal half the bound "
              f"({2 * t[2]:.4f} ms): "
              f"{'met' if t[0] <= 2 * t[2] else 'not met'}")
        check(t[0] < lib, f"the bf16 flash_attention kernel ({t[0]:.4f} ms) "
              f"is not faster than scaled_dot_product_attention "
              f"({lib:.4f} ms) at {(B, H, KV, S, D)}")
        del q, k, v, mask
        torch.cuda.empty_cache()
        return worst, t

    # danube's prefill (before the tensor-core kernel: the SIMT
    # kernel's FLASH_SIMT_BF16_MS), then phi3-mini's, at head dim 96
    worst80, t = timing(4, 32, 8, 4608, 80, 4096, worst[False])
    print(f"[lm-kernels] flash_attention at danube's prefill before the "
          f"tensor-core kernel: the SIMT kernel {FLASH_SIMT_BF16_MS} ms "
          f"(PERF.md)")
    worst96, t96 = timing(4, 32, 32, 4064, 96, 0, worst[True])
    # olmoe-1b-7b's prefill, at head dim 128
    worst128, t128 = timing(*OLMOE_FLASH, 0, worst[False])
    return worst80, t, worst96, t96, worst128, t128


def flex_softcap(torch, S, W, gqa):
    """The capped kernels' library yardstick: ``flex_attention`` under
    ``torch.compile`` with a ``softcap·tanh(s / softcap)`` score_mod and a
    causal (windowed) block mask → (call on (q, k, v), None) or (None, why
    it does not run here).  The first call compiles it."""
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
    except ImportError as e:
        return None, f"no flex_attention in torch {torch.__version__} ({e})"

    def mask_mod(b, h, qi, ki):
        ok = ki <= qi
        return ok & (ki > qi - W) if W else ok

    def score_mod(score, b, h, qi, ki):
        return SOFTCAP * torch.tanh(score / SOFTCAP)
    # the timing calls its backward again on one graph (retain_graph), which
    # buffers donated to the compiled backward would forbid
    import torch._functorch.config as functorch_config
    functorch_config.donated_buffer = False
    block = create_block_mask(mask_mod, None, None, S, S, device="cuda")
    compiled = torch.compile(flex_attention)
    return (lambda q, k, v: compiled(q, k, v, score_mod=score_mod,
                                     block_mask=block, enable_gqa=gqa)), None


def softcap_checks(torch):
    """The capped flash kernels (``softcap`` = SOFTCAP, the capped
    instantiation of each of the four kernels) against the plain version
    and its autograd, on q and k scaled by SOFTCAP_QK so that the cap bites
    (the share of one head's scaled scores past SOFTCAP / 2 is printed, and
    the uncapped output must lie far past the tolerance): the forward on
    both routes at SOFTCAP_FWD_CASES, the backward at SOFTCAP_BWD_CASES (one
    (b, KV head) slice of the plain version at a time).  Then, at danube's
    prefill and training shapes in bf16, the capped kernels' time beside
    the uncapped ones' in the same run, the plain version's and
    flex_attention's with a tanh score_mod → (worst forward error, forward
    timing, worst backward error, backward timing)."""
    import math
    from repro_torch.kernels import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_backward
    gen = torch.Generator(device="cuda").manual_seed(27)
    routes = {"float32": "simt_f32", "bfloat16": "wgmma_bf16"}

    def qkv(B, H, KV, S, D, dtype):
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * scale).to(dtype)
        return (rnd(B, H, S, D, scale=SOFTCAP_QK),
                rnd(B, KV, S, D, scale=SOFTCAP_QK), rnd(B, KV, S, D))

    def bites(q, k, D):
        """Share of head (0, 0)'s scaled scores past SOFTCAP / 2."""
        s = torch.einsum("sd,td->st", q[0, 0].float(),
                         k[0, 0].float()) / math.sqrt(D)
        return float((s.abs() > SOFTCAP / 2).float().mean())

    worst_f, t_fwd = 0.0, None
    for (B, H, KV, S, D), W, dt in SOFTCAP_FWD_CASES:
        dtype, route = getattr(torch, dt), routes[dt]
        name = (f"flash_attention[{route}] softcap {SOFTCAP:g} "
                f"{(B, H, KV, S, D)} window={W} {dt}")
        q, k, v = qkv(B, H, KV, S, D, dtype)
        before = (flash_attention.route_launches[route],
                  flash_attention.capped_launches)
        got = flash_attention(q, k, v, window=W, softcap=SOFTCAP)
        check((flash_attention.route_launches[route],
               flash_attention.capped_launches)
              == (before[0] + 1, before[1] + 1),
              f"{name} did not launch the capped {route} kernel")
        want = flash_attention_ref(q, k, v, window=W, softcap=SOFTCAP)
        worst_f = lm_check(torch, name, got, want, dtype, worst_f)
        far = rel_err(torch, flash_attention_ref(q, k, v, window=W).float(),
                      want.float())
        print(f"[softcap] {name}: {100 * bites(q, k, D):.1f} % of head "
              f"(0, 0)'s scaled scores past {SOFTCAP / 2:g}; the uncapped "
              f"output lies {far:.3e} from the capped one (normwise), "
              f"{far / LM_TOL[str(dtype)]:.0f}x the tolerance")
        check(far > 10 * LM_TOL[str(dtype)],
              f"{name}: the cap does not bite")
        del got, want
        if (dt, S) == ("bfloat16", 4608):
            t_fwd = softcap_fwd_timing(torch, q, k, v, W)
        del q, k, v
        torch.cuda.empty_cache()

    worst_b, t_bwd = 0.0, None
    for (B, H, KV, S, D), W, dt in SOFTCAP_BWD_CASES:
        dtype, route = getattr(torch, dt), routes[dt]
        G = H // KV
        name = (f"flash_attention backward[{route}] softcap {SOFTCAP:g} "
                f"{(B, H, KV, S, D)} window={W} {dt}")
        q, k, v = qkv(B, H, KV, S, D, dtype)
        dout = torch.randn(B, H, S, D, generator=gen, device="cuda").to(dtype)
        before = (flash_attention_backward.route_launches[route],
                  flash_attention_backward.capped_launches)
        got = _grads(torch, lambda q, k, v: flash_attention(
            q, k, v, window=W, softcap=SOFTCAP), [q, k, v], dout)
        check((flash_attention_backward.route_launches[route],
               flash_attention_backward.capped_launches)
              == (before[0] + 1, before[1] + 1),
              f"{name} did not launch the capped {route} kernels")
        want = [torch.empty_like(t) for t in got]
        far = 0.0
        for b in range(B):
            for j in range(KV):
                hs = slice(j * G, (j + 1) * G)
                sl = [q[b:b + 1, hs], k[b:b + 1, j:j + 1],
                      v[b:b + 1, j:j + 1]]
                g3 = _grads(torch, lambda q, k, v: flash_attention_ref(
                    q, k, v, window=W, softcap=SOFTCAP), sl,
                    dout[b:b + 1, hs])
                u3 = _grads(torch, lambda q, k, v: flash_attention_ref(
                    q, k, v, window=W), sl, dout[b:b + 1, hs])
                far = max(far, max(rel_err(torch, u.float(), g.float())
                                   for u, g in zip(u3, g3)))
                want[0][b, hs], want[1][b, j], want[2][b, j] = \
                    g3[0][0], g3[1][0, 0], g3[2][0, 0]
                del g3, u3
        worst_b = grad_check(torch, name, got, want, dtype, worst_b)
        print(f"[softcap] {name}: {100 * bites(q, k, D):.1f} % of head "
              f"(0, 0)'s scaled scores past {SOFTCAP / 2:g}; the uncapped "
              f"gradients lie up to {far:.3e} from the capped ones "
              f"(normwise), {far / LM_TOL[str(dtype)]:.0f}x the tolerance")
        check(far > 10 * LM_TOL[str(dtype)],
              f"{name}: the cap does not bite")
        del got, want
        if dt == "bfloat16":
            t_bwd = softcap_bwd_timing(torch, q, k, v, dout, W)
        del q, k, v, dout
        torch.cuda.empty_cache()
    return worst_f, t_fwd, worst_b, t_bwd


def softcap_fwd_timing(torch, q, k, v, W):
    """The capped bf16 forward's time beside the uncapped kernel's in the
    same run (capped, uncapped, uncapped, capped), the plain capped
    version's and flex_attention's → (ms, plain, bound, bound_by,
    library)."""
    from repro_torch.kernels import (flash_attention_ref,
                                     flash_attention_work, flash_pairs)
    from repro_torch.kernels.flash_attention import flash_attention_forward
    B, H, S, D = q.shape
    KV = k.shape[1]

    def run(cap):
        return lambda: flash_attention_forward(q, k, v, window=W,
                                               softcap=cap)
    ms1, host = cuda_ms(torch, run(SOFTCAP), 20)
    unc1, _ = cuda_ms(torch, run(0.0), 20)
    unc2, _ = cuda_ms(torch, run(0.0), 20)
    ms2, _ = cuda_ms(torch, run(SOFTCAP), 20)
    plain, _ = cuda_ms(torch, lambda: flash_attention_ref(
        q, k, v, window=W, softcap=SOFTCAP), 2, 1)
    lib, why = flex_softcap(torch, S, W, H != KV)
    lib_ms = None
    if lib is not None:
        t0 = time.perf_counter()
        lib_err = rel_err(torch, lib(q, k, v).float(), flash_attention_ref(
            q, k, v, window=W, softcap=SOFTCAP).float())
        compile_s = time.perf_counter() - t0
        lib_ms, _ = cuda_ms(torch, lambda: lib(q, k, v), 10)
        why = (f"flex_attention (tanh score_mod, block mask, compiled in "
               f"{compile_s:.1f} s; rel err vs plain {lib_err:.2e}) "
               f"{lib_ms:.4f} ms")
    pairs, _ = flash_pairs(S, True, W)
    ops, nbytes = flash_attention_work(B, H, KV, S, D, q.dtype, window=W)
    b_ms, b_by = bound_ms_bf16(nbytes, ops)
    t = (min(ms1, ms2), plain, b_ms, b_by, lib_ms)
    print(f"[softcap] flash_attention forward timing {(B, H, KV, S, D)} "
          f"window {W} bf16, softcap {SOFTCAP:g}: capped {ms1:.4f} / "
          f"{ms2:.4f} ms, uncapped {unc1:.4f} / {unc2:.4f} ms on the card "
          f"(capped, uncapped, uncapped, capped; {host:.4f} ms of host "
          f"time), capped/uncapped {t[0] / min(unc1, unc2):.3f}x, "
          f"{100 * b_ms / t[0]:.1f} % of the bound {b_ms:.6f} ms ({b_by}: "
          f"the products of {pairs} unmasked pairs a head; the tanh is not "
          f"counted); plain {plain:.3f} ms; library: {why}")
    return t


def softcap_bwd_timing(torch, q, k, v, dout, W):
    """The capped bf16 backward's time beside the uncapped kernels' in the
    same run, each from its own forward's output and log-sum-exp; the plain
    capped backward's (each (b, KV head) slice's measured time, summed) and
    flex_attention's backward → (ms, plain, bound, bound_by, library)."""
    from repro_torch.kernels import (flash_attention_ref,
                                     flash_attention_work, flash_pairs)
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    saved = {cap: flash_attention_forward(q, k, v, window=W, softcap=cap)
             for cap in (SOFTCAP, 0.0)}

    def run(cap):
        out, lse = saved[cap]
        return lambda: flash_attention_backward(q, k, v, out, dout, lse,
                                                window=W, softcap=cap)
    same = all(torch.equal(a, b) for a, b in zip(run(SOFTCAP)(),
                                                 run(SOFTCAP)()))
    check(same, "two capped flash backward launches differ")
    ms1, host = cuda_ms(torch, run(SOFTCAP), 3, 1)
    unc1, _ = cuda_ms(torch, run(0.0), 3, 1)
    unc2, _ = cuda_ms(torch, run(0.0), 3, 1)
    ms2, _ = cuda_ms(torch, run(SOFTCAP), 3, 1)
    del saved
    slice_ms = []
    for b in range(B):
        for j in range(KV):
            hs = slice(j * G, (j + 1) * G)
            qs = q[b:b + 1, hs].detach().requires_grad_(True)
            ks, vs = (t[b:b + 1, j:j + 1].detach().requires_grad_(True)
                      for t in (k, v))
            o1 = flash_attention_ref(qs, ks, vs, window=W, softcap=SOFTCAP)
            slice_ms.append(cuda_ms(torch, lambda: torch.autograd.grad(
                o1, (qs, ks, vs), dout[b:b + 1, hs], retain_graph=True),
                2, 1)[0])
            del o1, qs, ks, vs
    plain = sum(slice_ms)
    lib, why = flex_softcap(torch, S, W, H != KV)
    lib_ms = None
    if lib is not None:
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        t0 = time.perf_counter()
        lo = lib(ql, kl, vl)
        torch.autograd.grad(lo, (ql, kl, vl), dout, retain_graph=True)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        lib_ms, _ = cuda_ms(torch, lambda: torch.autograd.grad(
            lo, (ql, kl, vl), dout, retain_graph=True), 3, 1)
        why = (f"flex_attention's backward (tanh score_mod, compiled in "
               f"{compile_s:.1f} s) {lib_ms:.3f} ms")
        del lo, ql, kl, vl
    pairs, _ = flash_pairs(S, True, W)
    ops, nbytes = flash_attention_work(B, H, KV, S, D, q.dtype, window=W,
                                       backward=True)
    b_ms, b_by = bound_ms_bf16(nbytes, ops)
    t = (min(ms1, ms2), plain, b_ms, b_by, lib_ms)
    print(f"[softcap] flash_attention backward timing {(B, H, KV, S, D)} "
          f"window {W} bf16, softcap {SOFTCAP:g}: capped {ms1:.3f} / "
          f"{ms2:.3f} ms, uncapped {unc1:.3f} / {unc2:.3f} ms on the card "
          f"(capped, uncapped, uncapped, capped; {host:.4f} ms of host "
          f"time), capped/uncapped {t[0] / min(unc1, unc2):.3f}x, "
          f"{100 * b_ms / t[0]:.2f} % of the bound {b_ms:.6f} ms ({b_by}); "
          f"a second launch bit for bit: {same}; plain {plain:.3f} ms (the "
          f"sum of {B * KV} slices); library: {why}")
    return t


def ssd_scan_checks(torch):
    """ssd_scan at mamba2-130m's prefill (B=4, prompt 4096, chunk 32 → C=128,
    H=24, P=64, N=128), f32."""
    from repro_torch.kernels import ssd_scan, ssd_scan_ref, ssd_scan_work
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
    ops, nbytes = ssd_scan_work(B, C, H, P, N)
    t = (ms, plain, *bound_ms(nbytes, ops), None)
    print(f"[lm-kernels] ssd_scan timing {(B, C, H, P, N)}: kernel "
          f"{ms:.4f} ms on the card ({host:.4f} ms of host time to launch), "
          f"plain {plain:.3f} ms, bound {t[2]:.6f} ms ({t[3]}: {nbytes} B, "
          f"{ops} ops)")
    return worst, t


def serve_phase(torch, arch, batch, prompt, steps, cut=None):
    """Drive ``repro_torch.launch.serve`` at full width (``serve.main``), or
    on the registered config cut by ``cut`` (``serve.serve``); → (launches,
    the ``ServeResult``)."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    from repro_torch.launch import serve
    kernels = (rmsnorm, flash_attention, ssd_scan)
    cfg = get(arch).config
    if cut:
        cfg = dataclasses.replace(cfg, **cut)
        print(f"[serve] {arch} cut to fit one card: dataclasses.replace("
              f"config, {', '.join(f'{k}={v}' for k, v in cut.items())})")
    for k in kernels:
        k.launches = 0
    for routes in (flash_attention.route_launches, rmsnorm.route_launches):
        for route in routes:
            routes[route] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if cut:
        res = serve.serve(cfg, batch, prompt, steps)
    else:
        res = serve.main(["--arch", arch, "--batch", str(batch), "--prompt",
                          str(prompt), "--steps", str(steps)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in kernels}
    launches.update(flash_attention.route_launches)
    launches["rmsnorm_routes"] = dict(rmsnorm.route_launches)
    print(f"[serve] {arch} {cfg.dtype}"
          f"{' int8 weights' if cfg.quantize_weights else ''} B={batch} "
          f"prompt={prompt} steps={steps}: prefill {res.prefill_ms:.3f} ms, "
          f"decode {res.decode_ms:.3f} ms for {steps - 1} steps "
          f"({res.decode_ms / max(1, steps - 1):.3f} ms a step, "
          f"{res.decode_tok_s:.1f} tok/s), wall {wall:.3f} s (weights "
          f"included; {res.weight_bytes} B of weights on the card, peak "
          f"{peak} B = {peak / 2**30:.2f} GiB allocated); launches "
          f"{launches}")
    check(tuple(res.tokens.shape) == (batch, steps)
          and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_size,
          f"{arch} serve returned invalid tokens")
    # per forward: each layer's norm1, norm2 (none for an FFN-less layer or
    # the parallel block) and a mamba layer's gated norm, which is an RMS
    # norm in every arch, then the final norm; prefill and steps - 1 decode
    # steps each run one forward
    rms = cfg.norm == "rmsnorm"
    per_fwd = rms + cfg.pattern_repeats * sum(
        rms * (1 + (f != "none" and not cfg.parallel_block)) + (m == "mamba")
        for m, f in cfg.block_pattern)
    want_rms = per_fwd * steps
    check(launches["rmsnorm"] == want_rms,
          f"{arch} serve launched rmsnorm {launches['rmsnorm']} times, not "
          f"{want_rms}")
    want_flash = cfg.pattern_repeats * sum(
        m == "attn" for m, _ in cfg.block_pattern)
    want_ssd = cfg.pattern_repeats * sum(
        m == "mamba" for m, _ in cfg.block_pattern)
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
    return launches, res


class MoEDrops:
    """While active, counts the (token, choice) assignments that every
    ``moe_route`` call of at least ``min_tokens`` tokens (a prefill's, not a
    decode step's) routes and drops at capacity; the counts stay on the
    card until read."""

    def __init__(self, min_tokens: int):
        self.min_tokens = min_tokens
        self.assignments, self.dropped, self.calls = 0, [], 0

    def _route(self, router, x, cfg):
        route = self._orig(router, x, cfg)
        if x.shape[0] >= self.min_tokens:
            self.calls += 1
            self.assignments += route.slot.numel()
            self.dropped.append((~route.kept()).sum())
        return route

    def __enter__(self):
        from repro_torch.models import layers
        self._orig = layers.moe_route
        layers.moe_route = self._route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.moe_route = self._orig

    def total(self) -> int:
        return int(sum(int(d) for d in self.dropped))


def decode_consistency(torch, arch, prompt, n, batch=2, cut=None):
    """Full-width float32: prefill(prompt) + n greedy decode steps against
    forward over prompt + generated (tests/test_models.py:21), on the
    registered config cut by ``cut``.  An MoE arch runs at capacity_factor
    E/k, where every expert has a slot for every token of a group: prefill
    routes B·prompt tokens a group and decode B, so with drops decode could
    not match forward (the reference's hybrid test raises the capacity for
    it, tests/test_models.py:63-75).  A VLM prefills and forwards with
    random vision embeds.  With a logit softcap prefill and forward run the
    capped f32 kernel (counted) and decode the capped plain scores, and the
    uncapped forward must lie far from the capped one."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.models import (decode_step, forward, init_params,
                                    prefill)
    change = dict(cut or {}, dtype="float32")
    base = get(arch).config
    if base.moe_experts:
        change["capacity_factor"] = base.moe_experts / base.moe_top_k
    cfg = dataclasses.replace(base, **change)
    from repro_torch.kernels import flash_attention
    flash_attention.capped_launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = init_params(cfg, seed=0, device="cuda")
        gen = torch.Generator().manual_seed(5)
        toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                             generator=gen, dtype=torch.int32).cuda()
        ve = None
        if cfg.vision_tokens:
            check(prompt > cfg.vision_tokens, f"{arch}: the prompt must be "
                  f"longer than its {cfg.vision_tokens} vision tokens")
            ve = torch.randn(batch, cfg.vision_tokens, cfg.d_model,
                             generator=gen).cuda()
        logits, caches = prefill(params, cfg, toks, vision_embeds=ve,
                                 ssd_chunk=32, max_len=prompt + n)
        steps = [logits[:, -1]]
        del logits
        tok = torch.argmax(steps[0][:, None], -1).to(torch.int32)
        gen_toks = [tok]
        for i in range(n - 1):
            logits, caches = decode_step(params, cfg, tok, caches, prompt + i)
            steps.append(logits[:, -1])
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            gen_toks.append(tok)
        seq = torch.cat([toks] + gen_toks[:-1], dim=1)
        full = forward(params, cfg, seq, vision_embeds=ve,
                       ssd_chunk=32)[:, prompt - 1:]
        got = torch.stack(steps, dim=1)
        capped = flash_attention.capped_launches
        if cfg.attn_logit_softcap:
            far = rel_err(torch, forward(
                params, dataclasses.replace(cfg, attn_logit_softcap=0.0),
                seq, vision_embeds=ve, ssd_chunk=32)[:, prompt - 1:], full)
        torch.cuda.synchronize()
    if cfg.attn_logit_softcap:
        n_attn = cfg.pattern_repeats * sum(m == "attn"
                                           for m, _ in cfg.block_pattern)
        print(f"[consistency] {arch} float32 softcap "
              f"{cfg.attn_logit_softcap:g}: the uncapped forward lies "
              f"{far:.3e} from the capped one (normwise), "
              f"{far / CONSISTENCY_TOL:.0f}x the tolerance; capped f32 flash "
              f"launches {capped} (prefill and forward)")
        check(far > 100 * CONSISTENCY_TOL, f"{arch}: the cap does not bite")
        check(capped == 2 * n_attn, f"{arch}: {capped} capped flash "
              f"launches, not {2 * n_attn}")
    err = rel_err(torch, got, full)
    same = bool(torch.equal(torch.cat(gen_toks, 1),
                            torch.argmax(full, -1).to(torch.int32)))
    what = [f"{k}={v}" for k, v in change.items() if k != "dtype"]
    if ve is not None:
        what.append(f"{cfg.vision_tokens} vision embeds")
    print(f"[consistency] {arch} float32"
          f"{' (' + ', '.join(what) + ')' if what else ''}"
          f" B={batch} prompt={prompt} + {n} decode steps vs forward: "
          f"logits rel err {err:.3e} (tol {CONSISTENCY_TOL:g}), greedy "
          f"tokens equal: {same} ({time.perf_counter() - t0:.2f} s)")
    check(err <= CONSISTENCY_TOL and same,
          f"{arch} decode disagrees with forward")
    del params, caches


def quantize_phase(torch):
    """``[quantize]``: QUANT's arch at full width and depth in float32,
    its ``quantize_params`` tree against the unquantized weights, on the
    reference's own bounds (tests/test_quantize.py:41-57): the forward's
    max-abs error relative to the max logit below QUANT_REL, the quantized
    prefill + teacher-forced decode within QUANT_DECODE of the quantized
    forward, the quantized weights' bytes below 1/QUANT_BYTES of the f32
    tree's → the int8 tree's bytes."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.models import (decode_step, forward, init_params,
                                    prefill, quantize_params)
    from repro_torch.models.params import tree_leaves
    arch, B, S, prompt, n = QUANT
    cfg = dataclasses.replace(get(arch).config, dtype="float32")
    qcfg = dataclasses.replace(cfg, quantize_weights=True)
    gen = torch.Generator().manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         dtype=torch.int32).cuda()
    with torch.inference_mode():
        params = init_params(cfg, seed=0, device="cuda")
        f32_bytes = sum(a.numel() * a.element_size()
                        for a in tree_leaves(params))
        qp = quantize_params(params, cfg)
        q_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(qp))
        base = forward(params, cfg, toks, ssd_chunk=32)
        del params
        out = forward(qp, qcfg, toks, ssd_chunk=32)
        rel = float((base - out).abs().max() / base.abs().max())
        del base, out
        seq = toks[:, :prompt + n]
        full = forward(qp, qcfg, seq, ssd_chunk=32)
        _, caches = prefill(qp, qcfg, seq[:, :prompt], ssd_chunk=32,
                            max_len=prompt + n)
        err = 0.0
        for t in range(prompt, prompt + n):
            lg, caches = decode_step(qp, qcfg, seq[:, t:t + 1], caches, t)
            err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
        torch.cuda.synchronize()
    print(f"[quantize] {arch} float32 at full width and depth, int8 "
          f"weights: forward (B={B}, S={S}) max-abs error {rel:.4e} of the "
          f"max logit (bound {QUANT_REL}); prefill {prompt} + {n} decode "
          f"steps against the quantized forward: max abs {err:.3e} (bound "
          f"{QUANT_DECODE:g}); weights {q_bytes} B int8 + scales against "
          f"{f32_bytes} B f32, 1/{f32_bytes / q_bytes:.3f} (bound "
          f"1/{QUANT_BYTES})")
    check(rel < QUANT_REL, f"{arch}: the int8 forward is {rel:.3e} of the "
          f"max logit from the f32 one")
    check(err < QUANT_DECODE, f"{arch}: int8 decode is {err:.3e} from the "
          f"int8 forward")
    check(q_bytes < f32_bytes / QUANT_BYTES,
          f"{arch}: the int8 tree takes {q_bytes} B of {f32_bytes}")
    del qp, caches, full
    return q_bytes


def head_merge_phase(torch):
    """musicgen's prefill with ``attn_head_merge=True`` (B·H merged into the
    flash kernel's batch) against the unmerged prefill, at full width and
    depth in bf16: the logits bit for bit, every layer on the bf16 kernel."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention
    from repro_torch.models import init_params, prefill
    arch, B, S = MERGE
    cfg = get(arch).config
    merged = dataclasses.replace(cfg, attn_head_merge=True)
    n_attn = cfg.pattern_repeats * sum(m == "attn"
                                       for m, _ in cfg.block_pattern)
    gen = torch.Generator().manual_seed(10)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         dtype=torch.int32).cuda()
    with torch.inference_mode():
        params = init_params(cfg, seed=0, device="cuda")
        got = {}
        for name, c in (("unmerged", cfg), ("merged", merged)):
            before = flash_attention.route_launches["wgmma_bf16"]
            got[name], _ = prefill(params, c, toks, max_len=S)
            torch.cuda.synchronize()
            check(flash_attention.route_launches["wgmma_bf16"]
                  == before + n_attn,
                  f"{arch} {name} prefill did not launch the bf16 flash "
                  f"kernel once a layer")
        same = torch.equal(got["merged"], got["unmerged"])
    print(f"[head_merge] {arch} bf16 B={B} prompt={S}: prefill with "
          f"attn_head_merge (the flash kernel on (B·H={B * cfg.n_heads}, 1, "
          f"S, D)) against the unmerged one: logits bit for bit {same}; "
          f"{n_attn} bf16 flash launches each")
    check(same, f"{arch}: the merged prefill's logits differ from the "
          f"unmerged ones")
    del params, got


def softcap_serve_phase(torch):
    """The capped forward on a main path: danube's bf16 serve (SERVES'
    shape) with ``attn_logit_softcap=SOFTCAP``, every prefill layer on the
    capped bf16 kernel → (capped launches, the ServeResult)."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention
    from repro_torch.launch import serve
    arch, batch, prompt, steps = SERVES[0]
    cfg = dataclasses.replace(get(arch).config, attn_logit_softcap=SOFTCAP)
    flash_attention.capped_launches = 0
    flash_attention.route_launches["wgmma_bf16"] = 0
    res = serve.serve(cfg, batch, prompt, steps)
    launches = flash_attention.capped_launches
    n_attn = cfg.pattern_repeats * sum(m == "attn"
                                       for m, _ in cfg.block_pattern)
    print(f"[softcap] {arch} bf16 serve with attn_logit_softcap={SOFTCAP:g} "
          f"B={batch} prompt={prompt} steps={steps}: prefill "
          f"{res.prefill_ms:.3f} ms, decode {res.decode_ms:.3f} ms "
          f"({res.decode_tok_s:.1f} tok/s); capped flash launches "
          f"{launches}")
    check(launches == n_attn == flash_attention.route_launches["wgmma_bf16"],
          f"{arch}: the capped serve launched the capped bf16 kernel "
          f"{launches} times, not once a layer ({n_attn})")
    check(tuple(res.tokens.shape) == (batch, steps),
          f"{arch}: the capped serve returned invalid tokens")
    return launches, res


def softcap_train_phase(torch):
    """The capped backward on a main path: ``make_train_step`` for danube
    at full width and depth in bf16 with remat, ``attn_logit_softcap=
    SOFTCAP``, SOFTCAP_TRAIN_STEPS steps at [train]'s batch and sequence
    with the launcher's optimizer and data → capped backward launches."""
    import dataclasses
    import math
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.models import TrainState, init_params, make_train_step
    from repro_torch.optim import adamw, linear_warmup_cosine
    arch, batch, seq = TRAINS[0][:3]
    cfg = dataclasses.replace(get(arch).config, attn_logit_softcap=SOFTCAP)
    steps = SOFTCAP_TRAIN_STEPS
    opt = adamw(linear_warmup_cosine(3e-4, 10, steps), weight_decay=0.01)
    step_fn = make_train_step(cfg, opt, ssd_chunk=32)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch, seed=11), "cuda")
    params = init_params(cfg, seed=0, device="cuda")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    del params
    flash_attention.capped_launches = 0
    flash_attention_backward.capped_launches = 0
    losses, walls = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data.batch(step))
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
    n_attn = cfg.pattern_repeats * sum(m == "attn"
                                       for m, _ in cfg.block_pattern)
    fwd, bwd = (flash_attention.capped_launches,
                flash_attention_backward.capped_launches)
    print(f"[softcap] {arch} bf16 train steps with attn_logit_softcap="
          f"{SOFTCAP:g}, B={batch} S={seq}, remat: losses {losses}, step "
          f"walls {[round(w, 4) for w in walls]} s; capped launches: "
          f"forward {fwd}, backward {bwd}")
    check(all(math.isfinite(x) for x in losses),
          f"{arch}: a capped training loss is not finite")
    check(fwd == steps * 2 * n_attn and bwd == steps * n_attn,
          f"{arch}: the capped steps launched {fwd} forward and {bwd} "
          f"backward capped kernels, not {steps * 2 * n_attn} and "
          f"{steps * n_attn}")
    del state, metrics
    return bwd, walls


def search_phase(torch, g, arrays, plat, cfg):
    """``HSDAG(cfg).search(g, arrays, platform=plat)`` then ``place()``, the
    kernels' counts zeroed just before and read just after; → (result,
    greedy placement, launches).  Checks that every level_makespan launch
    took the staged route and every gcn_aggregate launch the vec4 route."""
    from repro_torch import HSDAG, simulate
    from repro_torch.kernels import gcn_aggregate, level_makespan
    agent = HSDAG(cfg)
    for k in (level_makespan, gcn_aggregate):
        k.launches = 0
        for route in k.route_launches:
            k.route_launches[route] = 0
    t0 = time.perf_counter()
    res = agent.search(g, arrays, platform=plat)
    placement = agent.place(arrays)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"level_makespan": level_makespan.launches,
                "level_makespan_routes": dict(level_makespan.route_launches),
                "gcn_aggregate": gcn_aggregate.launches,
                "gcn_aggregate_routes": dict(gcn_aggregate.route_launches)}
    label = f"[search engine={cfg.engine}]"
    for h in res.history:
        print(f"{label} episode {h['episode']}: wall {h['wall_s']:.3f} s, "
              f"mean reward {h['mean_reward']:.4f}, best "
              f"{h['best_latency'] * 1e3:.6f} ms, mean groups "
              f"{h['mean_groups']:.1f}")
    cpu_lat = simulate(g, [0] * g.num_nodes, plat).latency
    gpu_lat = simulate(g, [1] * g.num_nodes, plat).latency
    print(f"{label} {g.name} B={cfg.batch_chains} T={cfg.update_timestep} "
          f"hidden={cfg.hidden_channel}: {res.num_evaluations} evaluations "
          f"in {res.wall_time_s:.3f} s ({res.evals_per_sec:.1f} evals/s); "
          f"best {res.best_latency * 1e3:.6f} ms; cpu_only "
          f"{cpu_lat * 1e3:.6f} ms, gpu_only {gpu_lat * 1e3:.6f} ms (host "
          f"simulate)")
    print(f"{label} launches over search + place(): {launches} (search + "
          f"place took {wall:.3f} s)")
    check(launches["level_makespan_routes"]["staged"]
          == launches["level_makespan"],
          f"the {cfg.engine} search's level_makespan launches did not all "
          f"take the staged route")
    check(launches["gcn_aggregate"] > 0,
          "the encoder never launched the gcn kernel")
    check(launches["gcn_aggregate_routes"]["vec4"]
          == launches["gcn_aggregate"],
          "the encoder's gcn launches (hidden 128) did not all take the "
          "vec4 route")
    return res, placement, launches


def counted(torch, fn):
    """``fn()`` with the search kernels' launch counts zeroed just before it
    and read just after it → (its result, {kernel: launches})."""
    from repro_torch.kernels import (gcn_aggregate, level_makespan,
                                     sage_aggregate)
    kernels = {"level_makespan": level_makespan,
               "gcn_aggregate": gcn_aggregate,
               "sage_aggregate": sage_aggregate}
    for k in kernels.values():
        k.launches = 0
        for route in getattr(k, "route_launches", {}):
            k.route_launches[route] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in kernels.items()}


def best_is_host(g, plat, res, label):
    """The search's best latency against the host scheduler (default
    order) on its best placement."""
    from repro_torch import simulate
    host = simulate(g, res.best_placement, plat).latency
    print(f"{label} best {res.best_latency * 1e3:.6f} ms, host scheduler "
          f"{host * 1e3:.6f} ms; {res.num_evaluations} evaluations in "
          f"{res.wall_time_s:.3f} s ({res.evals_per_sec:.1f} evals/s)")
    check(abs(res.best_latency - host) <= TOL * host,
          f"{label} best latency disagrees with the host scheduler")


def slice_phases(torch, g, arrays, plat):
    """The search's other paths at full width on ``g``: population search,
    the K-epoch replay with parse dropout, the SAGE encoder (search and
    ``place()``), the scalar loop and a sampled ``place()``; each with the
    kernels' counts zeroed just before it and read just after it.
    → the SAGE path's launches."""
    from repro_torch import HSDAG, HSDAGConfig, simulate
    from repro_torch.core.train import PopulationConfig
    T = HSDAGConfig().update_timestep
    layers = HSDAGConfig().layer_gnn

    t_phase = time.perf_counter()
    res, n = counted(torch, lambda: HSDAG(HSDAGConfig(
        batch_chains=16, max_episodes=4)).search(
            g, arrays, platform=plat, population=PopulationConfig(
                cull_every=1, greedy_restart_every=2)))
    for h in res.history:
        print(f"[population] episode {h['episode']}: wall "
              f"{h['wall_s']:.3f} s, culled {h['culled']}, population best "
              f"{h['pop_best_latency'] * 1e3:.6f} ms, mean temperature "
              f"{h['temp_mean']:.4f}, best {h['best_latency'] * 1e3:.6f} ms")
    print(f"[population] launches: {n}")
    pop = [h["pop_best_latency"] for h in res.history]
    check(all(b <= a for a, b in zip(pop, pop[1:])),
          "the population's best latency rose between episodes")
    check(all(h["culled"] for h in res.history),
          "a population episode did not cull")
    best_is_host(g, plat, res, "[population]")
    check(n["level_makespan"] == 4 and n["gcn_aggregate"] > 0,
          "the population search did not score through level_makespan and "
          "encode through gcn_aggregate")
    print(f"[phase] population search: {time.perf_counter() - t_phase:.2f} s")

    t_phase = time.perf_counter()
    kcfg = HSDAGConfig(batch_chains=16, max_episodes=3, k_epochs=2,
                       dropout_parsing=0.1)
    kagent = HSDAG(kcfg)
    res, n = counted(torch, lambda: kagent.search(g, arrays, platform=plat))
    for h in res.history:
        print(f"[k_epochs] episode {h['episode']}: wall {h['wall_s']:.3f} "
              f"s, mean reward {h['mean_reward']:.4f}, best "
              f"{h['best_latency'] * 1e3:.6f} ms, mean groups "
              f"{h['mean_groups']:.1f}")
    print(f"[k_epochs] launches: {n}")
    best = [h["best_latency"] for h in res.history]
    check(all(b <= a for a, b in zip(best, best[1:])),
          "the K-epoch search's best latency rose between episodes")
    best_is_host(g, plat, res, "[k_epochs]")
    # per episode: the rollout's T steps, then k_epochs replays, each a
    # forward and a backward, of every layer
    want = kcfg.max_episodes * layers * T * (1 + 2 * kcfg.k_epochs)
    check(n["gcn_aggregate"] == want and n["level_makespan"] == 3,
          f"the K-epoch search launched gcn_aggregate {n['gcn_aggregate']} "
          f"times (want {want}) and level_makespan "
          f"{n['level_makespan']} times (want 3)")
    print(f"[phase] k_epochs=2 + dropout_parsing=0.1 search: "
          f"{time.perf_counter() - t_phase:.2f} s")

    t_phase = time.perf_counter()
    placement, n = counted(torch, lambda: kagent.place(
        arrays, torch.Generator(device="cuda").manual_seed(0),
        greedy=False))
    lat = simulate(g, placement, plat).latency
    print(f"[place] sampled placement (greedy=False): "
          f"{int((placement == 1).sum())} of {g.num_nodes} nodes on GPU, "
          f"latency {lat * 1e3:.6f} ms; launches {n}")
    check(placement.shape == (g.num_nodes,) and placement.min() >= 0
          and placement.max() < plat.num_devices and lat == lat and lat > 0,
          "place(greedy=False) returned an invalid placement")
    check(n["gcn_aggregate"] == layers, "the sampled place() did not encode "
          "through gcn_aggregate")
    print(f"[phase] sampled place: {time.perf_counter() - t_phase:.2f} s")

    t_phase = time.perf_counter()
    scfg = HSDAGConfig(batch_chains=16, max_episodes=3, gnn_model="sage")
    sagent = HSDAG(scfg)

    def sage_run():
        return sagent.search(g, arrays, platform=plat), sagent.place(arrays)
    (res, placement), sage_n = counted(torch, sage_run)
    for h in res.history:
        print(f"[sage] episode {h['episode']}: wall {h['wall_s']:.3f} s, "
              f"best {h['best_latency'] * 1e3:.6f} ms, mean groups "
              f"{h['mean_groups']:.1f}")
    print(f"[sage] launches over search + place(): {sage_n}")
    best_is_host(g, plat, res, "[sage]")
    # the rollout's forwards and the replay's forwards and backwards of
    # every layer, less one backward a window after the first (the first
    # layer of its first step aggregates the sampled state, which takes no
    # gradient), and place()'s forwards
    want = scfg.max_episodes * (layers * T * 3 - 1) + 1 + layers
    check(sage_n["sage_aggregate"] == want and sage_n["gcn_aggregate"] == 0,
          f"the SAGE encoder launched sage_aggregate "
          f"{sage_n['sage_aggregate']} times (want {want}) and "
          f"gcn_aggregate {sage_n['gcn_aggregate']} times (want 0)")
    check(placement.shape == (g.num_nodes,), "SAGE place() failed")
    print(f"[phase] sage search + place: {time.perf_counter() - t_phase:.2f} "
          f"s")

    t_phase = time.perf_counter()
    calls = []

    def reward_fn(p):
        calls.append(1)
        r = simulate(g, p, plat)
        return r.reward, r.latency
    res, n = counted(torch, lambda: HSDAG(HSDAGConfig(
        batch_chains=1, max_episodes=1)).search(
            g, arrays, reward_fn=reward_fn))
    print(f"[scalar] launches: {n}; reward_fn called {len(calls)} times")
    best_is_host(g, plat, res, "[scalar]")
    check(len(calls) == T and n["gcn_aggregate"] == 3 * layers * T
          and n["level_makespan"] == 0,
          "the scalar loop did not score each placement on the host")
    print(f"[phase] scalar loop: {time.perf_counter() - t_phase:.2f} s")
    return sage_n

def device_head_phase(torch, g, arrays):
    """The device head (``head="device"``) on ``g`` over the eight-GPU
    fleet at the Table-6 widths: 3 episodes with the default engine (the
    scan reward, its capacity mask on) and ``place()``, 1 episode with
    ``engine="level"``, then 2 episodes of a population with a greedy
    restart every window; each with the kernels' counts zeroed just before
    it and read just after it, each best latency held against the host
    scheduler in its engine's order."""
    from repro_torch import HSDAG, HSDAGConfig, simulate
    from repro_torch.core.sim import LevelBackend
    from repro_torch.core.train import PopulationConfig
    fleet = eight_gpus()

    def cfg(**kw):
        return HSDAGConfig(batch_chains=16, head="device",
                           num_devices=fleet.num_devices, **kw)

    t_phase = time.perf_counter()
    agent = HSDAG(cfg(max_episodes=3))

    def run():
        return agent.search(g, arrays, platform=fleet), agent.place(arrays)
    (res, placement), n = counted(torch, run)
    for h in res.history:
        print(f"[device_head] episode {h['episode']}: wall "
              f"{h['wall_s']:.3f} s, mean reward {h['mean_reward']:.4f}, "
              f"best {h['best_latency'] * 1e3:.6f} ms, mean groups "
              f"{h['mean_groups']:.1f}")
    print(f"[device_head] launches over search + place(): {n}")
    best_is_host(g, fleet, res, "[device_head]")
    check(n["level_makespan"] == 3 and n["gcn_aggregate"] > 0,
          "the device head's search did not score each window through "
          "level_makespan and encode through gcn_aggregate")
    greedy = simulate(g, placement, fleet).latency
    print(f"[device_head] greedy place(): devices used "
          f"{sorted(set(placement.tolist()))}, latency {greedy * 1e3:.6f} ms")
    check(placement.shape == (g.num_nodes,) and placement.min() >= 0
          and placement.max() < fleet.num_devices and greedy == greedy,
          "the device head's place() returned an invalid placement")

    lres, n = counted(torch, lambda: HSDAG(cfg(max_episodes=1)).search(
        g, arrays, platform=fleet, engine="level"))
    order = LevelBackend(device="cuda").prepare(g, fleet).arrays.order
    host = simulate(g, lres.best_placement, fleet, order=order).latency
    print(f"[device_head] engine='level': episode wall "
          f"{lres.history[0]['wall_s']:.3f} s, best "
          f"{lres.best_latency * 1e3:.6f} ms, host scheduler (level order) "
          f"{host * 1e3:.6f} ms; launches {n}")
    check(abs(lres.best_latency - host) <= TOL * host,
          "the device head's level search disagrees with the host "
          "scheduler")
    check(n["level_makespan"] == 1, "the device head's level search did "
          "not score its window through level_makespan")

    pres, n = counted(torch, lambda: HSDAG(cfg(max_episodes=2)).search(
        g, arrays, platform=fleet, population=PopulationConfig(
            cull_every=1, greedy_restart_every=1)))
    for h in pres.history:
        print(f"[device_head] population episode {h['episode']}: wall "
              f"{h['wall_s']:.3f} s, culled {h['culled']}, population best "
              f"{h['pop_best_latency'] * 1e3:.6f} ms")
    print(f"[device_head] population launches: {n}")
    check(all(h["culled"] for h in pres.history),
          "a device-head population episode did not cull")
    best_is_host(g, fleet, pres, "[device_head population]")
    check(n["level_makespan"] == 2, "the device head's population did not "
          "score each window through level_makespan")
    print(f"[phase] device head: {time.perf_counter() - t_phase:.2f} s")


def capacity_phase(torch, g, arrays):
    """The device head's capacity mask: one episode of 16 chains with the
    default engine on a fleet whose second island holds 5.12 MB a GPU,
    which 8 nodes of ``g`` exceed.  Every placement the window samples must
    put each node on a device its bytes fit (``SimArrays.fit_ok``); the
    window's placements are read where the search scores them."""
    from repro_torch import HSDAG, HSDAGConfig
    from repro_torch.core.costmodel import sim_arrays
    from repro_torch.core.sim import RewardPipeline
    from repro_torch.platforms import nvlink_island
    t_phase = time.perf_counter()
    fleet = nvlink_island(**CAPACITY_FLEET)
    fit_ok = sim_arrays(g, fleet).fit_ok
    blocked = (~fit_ok).sum(0).tolist()
    print(f"[capacity] fleet capacities "
          f"{[d.mem_capacity for d in fleet.devices]} B; nodes that do not "
          f"fit, per device: {blocked}")
    check(blocked == [0] * 4 + [8] * 4, "the capacity fleet's fit_ok is not "
          "8 nodes short on each GPU of the second island")
    seen = []
    score = RewardPipeline.score_window

    def spy(self, fines):
        seen.extend(f.clone() for f in fines)     # one window a graph
        return score(self, fines)
    RewardPipeline.score_window = spy
    try:
        res, n = counted(torch, lambda: HSDAG(HSDAGConfig(
            batch_chains=16, head="device", num_devices=fleet.num_devices,
            max_episodes=1)).search(g, arrays, platform=fleet))
    finally:
        RewardPipeline.score_window = score
    fines = torch.cat(seen).reshape(-1, g.num_nodes).cpu().numpy()
    fits = fit_ok[np.arange(g.num_nodes), fines]
    on_second = int((fines >= 4).sum())
    print(f"[capacity] {fines.shape[0]} sampled placements, "
          f"{on_second} node placements on the second island, "
          f"{int((~fits).sum())} on a device the node does not fit; "
          f"launches {n}; episode wall {res.history[0]['wall_s']:.3f} s")
    check(fines.shape[0] == 16 * HSDAGConfig().update_timestep,
          "the capacity search did not score one window of 16 chains")
    check(bool(fits.all()), "a sampled placement put a node on a device "
                            "it does not fit: the capacity mask failed")
    best_is_host(g, fleet, res, "[capacity]")
    print(f"[phase] capacity mask: {time.perf_counter() - t_phase:.2f} s")


def load_topology():
    """The Table-13 record of ``tools/reference_topology_spread.py``, its
    workload featurized as there, and its fleets built with the port's
    builders → (doc, graph, arrays, {fleet: platform})."""
    from repro_torch import FeatureConfig, extract_features, platforms
    from repro_torch.graphs.synthetic import SYNTHETIC_FAMILIES
    with open(TOPO_JSON) as f:
        doc = json.load(f)
    check(doc["config"] == TOPO_CONFIG,
          f"{TOPO_JSON} holds config {doc['config']}, not {TOPO_CONFIG}")
    spec = dict(doc["graph"])
    g = SYNTHETIC_FAMILIES[spec.pop("family")](**spec)
    arrays = extract_features(g, FeatureConfig(**doc["features"]))
    fleets = {name: getattr(platforms, f["builder"])(**f["args"])
              for name, f in doc["fleets"].items()}
    return doc, g, arrays, fleets


def topology_phase(torch):
    """Table 13 on the card (``benchmarks/table13_topology.py``): on each
    fleet, the exact DP bound (the reference's, to 1e-12), the best single
    device, the dense and the device head's searches (seed 0) and the
    hybrid refinement of the device head's placement, each with its gap to
    the bound.  No search may beat the bound and the hybrid may not be
    worse than the placement it refines."""
    from repro_torch import HSDAG, HSDAGConfig, platforms, simulate
    from repro_torch.core.baselines import hybrid_placement
    t_phase = time.perf_counter()
    doc, g, arrays, fleets = load_topology()

    def table():
        for name, fleet in fleets.items():
            bound = platforms.dp_optimal(g, fleet).bound
            want = doc["dp_bound"][name]
            print(f"[topology] {name} D={fleet.num_devices} V={g.num_nodes}: "
                  f"dp_bound {bound * 1e6:.6f} us (reference "
                  f"{want * 1e6:.6f} us)")
            check(abs(bound - want) <= 1e-12 * want,
                  f"the DP bound on {name} is not the reference's")

            def row(method, lat):
                print(f"[topology] {name} {method}: {lat * 1e6:.6f} us, "
                      f"gap to bound {100 * (lat / bound - 1):.2f} %")
            single = min(simulate(g, np.full(g.num_nodes, d), fleet).latency
                         for d in range(fleet.num_devices))
            row("single_device", single)
            placed = {}
            for head in ("dense", "device"):
                res = HSDAG(HSDAGConfig(**dict(TOPO_CONFIG, head=head))
                            ).search(g, arrays, platform=fleet)
                row(f"rl_{head}", res.best_latency)
                check(res.best_latency >= bound * (1 - 1e-6),
                      f"rl_{head} on {name} is below the DP bound")
                placed[head] = res.best_placement
            base = simulate(g, placed["device"], fleet).latency
            _, hyb = hybrid_placement(g, placed["device"], fleet)
            row("hybrid", hyb)
            check(hyb <= base, f"the hybrid refinement on {name} is worse "
                               f"than the placement it refines")
    _, n = counted(torch, table)
    print(f"[topology] launches: {n}")
    check(n["level_makespan"] > 0 and n["gcn_aggregate"] > 0,
          "the Table-13 searches did not run the search's kernels")
    print(f"[phase] topology (Table 13): "
          f"{time.perf_counter() - t_phase:.2f} s")


def one_sided_p(port, ref) -> float:
    """One-sided Mann-Whitney p that the port's latencies are larger than
    the reference's; 1.0 when both samples hold one value and nothing else
    (no evidence either way, where the test's variance is 0)."""
    from scipy.stats import mannwhitneyu
    if np.unique(np.concatenate([port, ref])).size == 1:
        return 1.0
    return float(mannwhitneyu(port, ref, alternative="greater").pvalue)


def contract_phase(graphs, plat):
    """The port's search quality against the reference's: for each paper
    graph and engine, the port's best latency over seeds 0-11 beside the
    reference's (``tools/reference_search_spread.json``), and for the
    device head on two Table-13 fleets the host scheduler's latency of each
    seed's best placement beside the reference's
    (``tools/reference_topology_spread.json``); the one-sided Mann-Whitney
    p-value that the port's are larger.  Fails below ``CONTRACT_P``.  →
    the smallest p-value."""
    from repro_torch import HSDAG, HSDAGConfig, extract_features
    with open(SPREAD_JSON) as f:
        doc = json.load(f)
    check(doc["config"] == SPREAD_CONFIG,
          f"{SPREAD_JSON} holds config {doc['config']}, not "
          f"{SPREAD_CONFIG}")
    worst = 1.0
    for name in ("inception_v3", "resnet50", "bert_base"):
        g = graphs[name]
        arrays = extract_features(g)
        for engine in ("auto", "level"):
            seeds = doc["seeds"]
            ref = np.array([doc["results"][name][engine][str(s)]
                            for s in seeds])
            t0 = time.perf_counter()
            port = np.array([
                HSDAG(HSDAGConfig(seed=s, **SPREAD_CONFIG)).search(
                    g, arrays, platform=plat, engine=engine).best_latency
                for s in seeds])
            p = one_sided_p(port, ref)
            worst = min(worst, p)
            print(f"[contract] {name} engine={engine}: port median "
                  f"{np.median(port) * 1e3:.6f} ms (range "
                  f"{port.min() * 1e3:.6f}-{port.max() * 1e3:.6f}), "
                  f"reference median {np.median(ref) * 1e3:.6f} ms (range "
                  f"{ref.min() * 1e3:.6f}-{ref.max() * 1e3:.6f}), "
                  f"Mann-Whitney p(port worse) = {p:.4g}; {len(seeds)} "
                  f"port searches in {time.perf_counter() - t0:.2f} s")
            print(f"[contract] {name} engine={engine} port ms: "
                  f"{[round(float(x) * 1e3, 6) for x in port]}")
            check(p >= CONTRACT_P,
                  f"the port's search on {name} (engine={engine}) is worse "
                  f"than the reference's: p = {p:.3g} < {CONTRACT_P}")
    return min(worst, device_contract(), multi_contract(graphs, plat),
               corpus_contract(plat, CORPUS_SPEC, CORPUS_JSON),
               corpus_contract(plat, CORPUS_FULL_SPEC, CORPUS_FULL_JSON),
               baseline_contract(graphs, plat))


def multi_contract(graphs, plat):
    """The contract's joint-training pairs: for seeds 0-11 at
    ``MULTI_CONTRACT_CONFIG``, each paper graph's best latency of the
    port's ``MultiGraphTrainer`` over the three, and BERT-base's zero-shot
    greedy latency after training on Inception-v3 and ResNet-50, beside the
    reference's (``tools/reference_multi_spread.json``); the same test and
    limit as the search pairs.  → the smallest p-value."""
    from repro_torch import HSDAGConfig, MultiGraphTrainer, extract_features
    from repro_torch.core import shared_feature_config
    with open(MULTI_JSON) as f:
        doc = json.load(f)
    check(doc["config"] == MULTI_CONTRACT_CONFIG,
          f"{MULTI_JSON} holds config {doc['config']}, not "
          f"{MULTI_CONTRACT_CONFIG}")
    seeds, to = doc["seeds"], doc["transfer_to"]
    port = {name: [] for name in doc["joint"]}
    port[f"{to} zero-shot"] = []
    # what train() would featurize without arrays=, once for every seed
    runs = {}
    for part in ("joint", "transfer_from"):
        gs = [graphs[n] for n in doc[part]]
        fc = shared_feature_config(gs)
        runs[part] = (gs, [extract_features(g, fc) for g in gs], fc)
    to_arrays = extract_features(graphs[to], runs["transfer_from"][2])
    t0 = time.perf_counter()
    for s in seeds:
        cfg = HSDAGConfig(seed=s, **MULTI_CONTRACT_CONFIG)
        gs, arrays, fc = runs["joint"]
        res = MultiGraphTrainer(cfg).train(gs, arrays, platform=plat,
                                           feature_cfg=fc)
        for name, lat in zip(doc["joint"], res.best_latencies):
            port[name].append(float(lat))
        gs, arrays, fc = runs["transfer_from"]
        t = MultiGraphTrainer(cfg)
        t.train(gs, arrays, platform=plat, feature_cfg=fc)
        port[f"{to} zero-shot"].append(t.evaluate_zero_shot(
            graphs[to], platform=plat, arrays=to_arrays)[1])
    print(f"[contract] multi: {2 * len(seeds)} joint trainings in "
          f"{time.perf_counter() - t0:.2f} s")
    worst = 1.0
    for name, lat in port.items():
        part, key = (("transfer", to) if name.endswith("zero-shot")
                     else ("joint", name))
        ref = np.array([doc["results"][part][key][str(s)] for s in seeds])
        lat = np.array(lat)
        p = one_sided_p(lat, ref)
        worst = min(worst, p)
        print(f"[contract] multi {name}: port median "
              f"{np.median(lat) * 1e3:.6f} ms (range "
              f"{lat.min() * 1e3:.6f}-{lat.max() * 1e3:.6f}), reference "
              f"median {np.median(ref) * 1e3:.6f} ms (range "
              f"{ref.min() * 1e3:.6f}-{ref.max() * 1e3:.6f}), Mann-Whitney "
              f"p(port worse) = {p:.4g}")
        print(f"[contract] multi {name} port ms: "
              f"{[round(float(x) * 1e3, 6) for x in lat]}")
        check(p >= CONTRACT_P,
              f"the port's joint training ({name}) is worse than the "
              f"reference's: p = {p:.3g} < {CONTRACT_P}")
    return worst


def multi_phase(torch, graphs, plat):
    """Table 7 on the card (``benchmarks/table7_generalization.py``): one
    ``MultiGraphTrainer`` over the three paper graphs at ``MULTI_CONFIG``,
    then each graph held out (trained on the other two, seed 1, decoded
    zero-shot), then a ``save_policy`` / ``load_policy`` round trip in a
    temporary directory whose restored policy must hold the trained weights
    and decode the same greedy placements.  Each run's kernel counts are
    zeroed just before it and read just after it; best and greedy latencies
    are held against the host scheduler at 1e-5."""
    import tempfile
    from repro_torch import (HSDAGConfig, MultiGraphTrainer,
                             extract_features, simulate)
    from repro_torch.core.baselines import cpu_only, gpu_only
    t_phase = time.perf_counter()
    names = list(graphs)
    cfg = HSDAGConfig(**MULTI_CONFIG)
    trainer = MultiGraphTrainer(cfg)
    res, n = counted(torch, lambda: trainer.train(
        [graphs[k] for k in names], platform=plat))
    for h in res.history:
        print(f"[multi] joint episode {h['episode']}: wall "
              f"{h['wall_s']:.3f} s, mean reward {h['mean_reward']:.4f}, "
              f"best ms {[round(x * 1e3, 6) for x in h['per_graph_best']]}, "
              f"mean groups {h['mean_groups']:.1f}")
    walls = [h["wall_s"] for h in res.history[1:]]
    steady = cfg.update_timestep * len(names) * cfg.batch_chains \
        * len(walls) / sum(walls)
    print(f"[multi] joint G={len(names)} B={cfg.batch_chains} "
          f"T={cfg.update_timestep}: {res.num_evaluations} evaluations in "
          f"{res.wall_time_s:.3f} s ({res.evals_per_sec:.1f} evals/s; "
          f"{steady:.1f} evals/s over episodes 1-{len(walls)}); episode "
          f"wall median {np.median(walls):.3f} s (range "
          f"{min(walls):.3f}-{max(walls):.3f}); launches over train + "
          f"greedy decodes: {n}")
    check(n["level_makespan"] == cfg.max_episodes * len(names),
          f"the joint run scored {n['level_makespan']} windows through the "
          f"level kernel, not one a graph and episode")
    check(n["gcn_aggregate"] > 0, "the joint run never launched the gcn "
                                  "kernel")
    for i, name in enumerate(names):
        g = graphs[name]
        cpu = simulate(g, cpu_only(g), plat).latency
        gpu = simulate(g, gpu_only(g), plat).latency
        best, greedy = res.best_latencies[i], res.greedy_latencies[i]
        host_best = simulate(g, res.best_placements[i], plat).latency
        host_greedy = simulate(g, res.greedy_placements[i], plat).latency
        print(f"[multi] joint {name}: best {best * 1e3:.6f} ms (host "
              f"{host_best * 1e3:.6f}), greedy {greedy * 1e3:.6f} ms (host "
              f"{host_greedy * 1e3:.6f}); cpu_only {cpu * 1e3:.6f} ms, "
              f"gpu_only {gpu * 1e3:.6f} ms")
        check(abs(best - host_best) <= TOL * host_best
              and abs(greedy - host_greedy) <= TOL * host_greedy,
              f"the joint run's latencies on {name} disagree with the host "
              f"scheduler")

    for held in names:
        rest = [k for k in names if k != held]
        t = MultiGraphTrainer(HSDAGConfig(seed=1, **MULTI_CONFIG))

        def run():
            r = t.train([graphs[k] for k in rest], platform=plat)
            return r, t.evaluate_zero_shot(graphs[held], platform=plat)
        (r, (p, lat)), n = counted(torch, run)
        g = graphs[held]
        host = simulate(g, p, plat).latency
        cpu = simulate(g, cpu_only(g), plat).latency
        gpu = simulate(g, gpu_only(g), plat).latency
        w = [h["wall_s"] for h in r.history[1:]]
        print(f"[multi] held out {held} (trained on {'+'.join(rest)}): "
              f"zero-shot greedy {lat * 1e3:.6f} ms (host "
              f"{host * 1e3:.6f}), cpu_only {cpu * 1e3:.6f} ms, gpu_only "
              f"{gpu * 1e3:.6f} ms; training bests ms "
              f"{[round(float(x) * 1e3, 6) for x in r.best_latencies]}, "
              f"episode wall median {np.median(w):.3f} s, "
              f"{r.evals_per_sec:.1f} evals/s; launches {n}")
        check(p.shape == (g.num_nodes,) and abs(lat - host) <= TOL * host,
              f"the zero-shot decode of {held} disagrees with the host "
              f"scheduler")
        check(n["level_makespan"] > 0 and n["gcn_aggregate"] > 0,
              f"the run holding out {held} did not launch the search's "
              f"kernels")

    with tempfile.TemporaryDirectory() as d:
        trainer.save_policy(d, step=cfg.max_episodes)
        restored = MultiGraphTrainer(cfg)
        restored.init(extract_features(graphs[names[0]],
                                       trainer.feature_config))
        check(restored.load_policy(d) == cfg.max_episodes
              and restored.feature_config == trainer.feature_config,
              "load_policy did not restore the step and feature layout")
    check(all(torch.equal(a, b) for a, b in zip(
        restored.policy.parameters(), trainer.policy.parameters())),
        "the restored policy's weights are not the trained ones")
    for name in names:
        arrays = extract_features(graphs[name], trainer.feature_config)
        check(np.array_equal(restored.place(arrays), trainer.place(arrays)),
              f"the restored policy decodes {name} differently")
    print(f"[multi] save_policy / load_policy: weights equal, greedy "
          f"placements equal on {len(names)} graphs")
    print(f"[phase] multi (Table 7): {time.perf_counter() - t_phase:.2f} s")


def corpus_graphs(spec=CORPUS_FULL_SPEC, record=CORPUS_FULL_JSON):
    """Table 8's corpus (``spec``: the full one, or the one less
    ``traced``) and its held-out graphs, checked against the reference's
    ``record`` (names, sizes, bucket partition, fingerprint) → (corpus,
    held out, the record)."""
    from repro_torch.core import plan_buckets
    from repro_torch.graphs import build_corpus, corpus_fingerprint
    with open(record) as f:
        doc = json.load(f)
    check(doc["corpus"] == spec and doc["held_out"] == HELD_OUT_SPEC
          and doc["config"] == CORPUS_CONTRACT_CONFIG
          and doc["trainer"] == CORPUS_TRAINER,
          f"{record} records another corpus or config than "
          f"chip_smoke.py's")
    corpus, held = build_corpus(spec), build_corpus(HELD_OUT_SPEC)
    names = [g.name for g in corpus]
    sizes = [g.num_nodes for g in corpus]
    buckets = plan_buckets(sizes, CORPUS_TRAINER["max_buckets"])
    fp = corpus_fingerprint(corpus)
    print(f"[corpus] {len(corpus)} graphs: "
          f"{[(n, v) for n, v in zip(names, sizes)]}; buckets {buckets}; "
          f"fingerprint {fp}; held out "
          f"{[(g.name, g.num_nodes) for g in held]}")
    check(names == doc["graphs"] and sizes == doc["num_nodes"]
          and buckets == doc["buckets"] and fp == doc["fingerprint"]
          and [g.name for g in held] == doc["held_out_graphs"],
          "the port's corpus (graphs, buckets or fingerprint) is not the "
          "reference's")
    return corpus, held, doc


def corpus_kernel_checks(torch, corpus, held, plat):
    """The search kernels at the corpus's shapes (17-602 nodes, the LM
    layer chains of 26 and 50, the two 40-node traced layers):
    level_makespan on each graph's chain tables
    at a corpus window's B=80 and at B=1, bitwise against its plain
    version, and gcn_aggregate forward and backward at B=8, F=128 against
    its plain version at 1e-5, each printing its route → worst max abs
    errors (level, gcn)."""
    from repro_torch.core.sim import ScanBackend
    from repro_torch.kernels import (GCNAggregate, gcn_aggregate,
                                     gcn_aggregate_ref, gcn_graph)
    graphs = list(corpus) + list(held)
    lvl, _ = makespan_checks(
        torch, "node_scan[corpus]", ScanBackend(device="cuda"),
        [(g, plat, B) for g in graphs for B in (1, 80)], [],
        required=("staged",))
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    routes = dict.fromkeys(gcn_aggregate.route_launches, 0)
    B, F = 8, 128
    for g in graphs:
        V, E = g.num_nodes, g.num_edges
        graph = gcn_graph(g.edges, V, "cuda")
        keep = (torch.rand(B, E, generator=gen, device="cuda") < 0.8).float()
        h = torch.randn(B, V, F, generator=gen, device="cuda")
        gout = torch.randn(B, V, F, generator=gen, device="cuda")
        before = dict(gcn_aggregate.route_launches)
        out_k = gcn_aggregate(graph, keep, h)
        hk = h.clone().requires_grad_(True)
        (gk,) = torch.autograd.grad(GCNAggregate.apply(graph, keep, hk), hk,
                                    gout)
        out_r = gcn_aggregate_ref(graph, keep, h)
        hr = h.clone().requires_grad_(True)
        (gr,) = torch.autograd.grad(gcn_aggregate_ref(graph, keep, hr), hr,
                                    gout)
        torch.cuda.synchronize()
        took = [r for r, n in gcn_aggregate.route_launches.items()
                if n != before[r]]
        for r in took:
            routes[r] += gcn_aggregate.route_launches[r] - before[r]
        e_f, e_b = rel_err(torch, out_k, out_r), rel_err(torch, gk, gr)
        abs_err = float(max((out_k - out_r).abs().max(),
                            (gk - gr).abs().max()))
        worst = max(worst, abs_err)
        print(f"[kernels] gcn_aggregate[corpus] {g.name}: B={B} V={V} E={E} "
              f"F={F} routes {took}, forward rel err {e_f:.3e}, backward "
              f"rel err {e_b:.3e}, max abs err {abs_err:.3e}")
        check(e_f <= TOL and e_b <= TOL,
              f"gcn_aggregate disagrees with its plain version on {g.name}")
    print(f"[kernels] gcn_aggregate[corpus] launches per route: {routes}")
    return lvl, worst


def corpus_latencies_are_host(g, res, i, plat, label):
    """Graph ``i``'s best (when sampled) and greedy latency of a corpus
    run against the host scheduler at 1e-5 → whether it was sampled."""
    from repro_torch import simulate
    greedy = res.greedy_latencies[i]
    host_greedy = simulate(g, res.greedy_placements[i], plat).latency
    check(abs(greedy - host_greedy) <= TOL * host_greedy,
          f"{label} greedy latency of {g.name} disagrees with the host "
          f"scheduler")
    best = res.best_latencies[i]
    if not np.isfinite(best):
        return False
    host_best = simulate(g, res.best_placements[i], plat).latency
    check(abs(best - host_best) <= TOL * host_best,
          f"{label} best latency of {g.name} disagrees with the host "
          f"scheduler")
    return True


def corpus_phase(torch, plat):
    """Table 8 on the card (``benchmarks/table8_corpus.py``, its full
    corpus): the corpus and its record, the kernels at the corpus's
    shapes, ``train_corpus(rng=0)`` at ``CORPUS_CONFIG`` (each episode's
    wall and batch wait, prefetch hits and misses, Table 8's evals/s, the
    launches the code implies, every best and greedy latency against the
    host scheduler), ``save_policy``, then for each held-out graph its
    zero-shot decode, a scratch run and a warm-started one (``rng=1``);
    then a 6-episode run with a checkpoint each episode resumed to 12 (the
    straight run's graph sequence, the restored state bitwise what was
    saved), and a 3-episode ``stream:`` run whose caches hold at most 2
    graphs.  → worst kernel errors (level, gcn)."""
    import tempfile
    from repro_torch import CurriculumTrainer, HSDAGConfig, simulate
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.baselines import cpu_only
    from repro_torch.graphs import StreamingCorpus
    t_phase = time.perf_counter()
    corpus, held, _ = corpus_graphs()
    errs = corpus_kernel_checks(torch, corpus, held, plat)
    cfg = HSDAGConfig(**CORPUS_CONFIG)
    layers = cfg.layer_gnn
    g_sub = CORPUS_TRAINER["graphs_per_episode"]

    def implied(episodes, graphs_decoded, slots=g_sub):
        # a slot's window: one scoring launch, and T steps of the rollout,
        # then the replay forward and backward, each through every GCN
        # layer; a greedy decode: one step
        return {"level_makespan": episodes * slots,
                "gcn_aggregate": episodes * slots * 3 * cfg.update_timestep
                * layers + graphs_decoded * layers, "sage_aggregate": 0}

    trainer = CurriculumTrainer(cfg, **CORPUS_TRAINER)
    res, n = counted(torch, lambda: trainer.train_corpus(
        corpus, platform=plat, rng=0))
    for h in res.history:
        print(f"[corpus] episode {h['episode']} bucket {h['bucket']} "
              f"{h['graphs']}: wall {h['wall_s']:.3f} s, batch_wait "
              f"{h['batch_wait_s'] * 1e3:.3f} ms, mean reward "
              f"{h['mean_reward']:.4f}, mean groups {h['mean_groups']:.1f}")
    walls = [h["wall_s"] for h in res.history[len(res.buckets):]]
    rate = (cfg.update_timestep * cfg.batch_chains * g_sub * len(walls)
            / sum(walls))
    want = implied(cfg.max_episodes, len(corpus))
    print(f"[corpus] Table 8 G={g_sub} B={cfg.batch_chains} "
          f"T={cfg.update_timestep}: {res.num_evaluations} evaluations in "
          f"{res.wall_time_s:.3f} s ({res.evals_per_sec:.1f} evals/s); "
          f"Table 8's rate (episodes {len(res.buckets)}-"
          f"{cfg.max_episodes - 1}) {rate:.1f} evals/s; episode wall median "
          f"{np.median(walls):.3f} s; prefetch {trainer.prefetch_stats}; "
          f"launches over train + greedy decodes {n} (the code implies "
          f"{want})")
    check(n == want, f"the corpus run's launches {n} are not the {want} "
                     f"its episodes and decodes imply")
    sampled = 0
    for i, g in enumerate(corpus):
        sampled += corpus_latencies_are_host(g, res, i, plat, "[corpus]")
        print(f"[corpus] {g.name}: best {res.best_latencies[i] * 1e3:.6f} "
              f"ms, greedy {res.greedy_latencies[i] * 1e3:.6f} ms")
    print(f"[corpus] {sampled} of {len(corpus)} graphs sampled; every best "
          f"and greedy latency equals the host scheduler's to {TOL}")

    with tempfile.TemporaryDirectory() as d:
        policy = os.path.join(d, "policy")
        trainer.save_policy(policy)
        for g in held:
            cpu = simulate(g, cpu_only(g), plat).latency
            p, lat = trainer.evaluate_zero_shot(g, platform=plat)
            host = simulate(g, p, plat).latency
            check(abs(lat - host) <= TOL * host,
                  f"the zero-shot decode of {g.name} disagrees with the host "
                  f"scheduler")
            one = dict(CORPUS_TRAINER, max_buckets=1, graphs_per_episode=1)
            scratch = CurriculumTrainer(cfg, **one)
            rs, ns = counted(torch, lambda: scratch.train_corpus(
                [g], platform=plat, rng=1))
            warm = CurriculumTrainer(cfg, **one)
            warm.warm_start(policy)
            rw, nw = counted(torch, lambda: warm.train_corpus(
                [g], platform=plat, rng=1))
            for r, label in ((rs, "scratch"), (rw, "warm")):
                corpus_latencies_are_host(g, r, 0, plat,
                                          f"[corpus] {label}")
            target = float(rs.best_latencies[0])
            reach = next((h["episode"] + 1 for h in rw.history
                          if h["best_latency"] <= target), None)
            print(f"[corpus] held out {g.name} (V={g.num_nodes}): zero-shot "
                  f"{lat * 1e3:.6f} ms (vs cpu_only {cpu * 1e3:.6f} ms: "
                  f"{100 * (cpu - lat) / cpu:.1f}%); scratch best "
                  f"{target * 1e3:.6f} ms in {rs.episodes_run} episodes; "
                  f"warm best {rw.best_latencies[0] * 1e3:.6f} ms, warm "
                  f"episodes to the scratch best "
                  f"{reach if reach is not None else 'not reached'}; "
                  f"launches scratch {ns}, warm {nw}")
            for nk in (ns, nw):
                check(nk == implied(cfg.max_episodes, 1, slots=1),
                      f"a held-out run's launches {nk} are not what its "
                      f"episodes imply")

        # ---- resume: 6 episodes with a checkpoint each, then to 12 ----
        ckpt = os.path.join(d, "ckpt")
        half = CurriculumTrainer(cfg, **CORPUS_TRAINER)
        first = half.train_corpus(corpus, platform=plat, rng=0,
                                  episodes=cfg.max_episodes // 2,
                                  checkpoint_dir=ckpt, checkpoint_every=1)
        mgr = CheckpointManager(ckpt)
        man = mgr.manifest(mgr.latest_step())
        probe = CurriculumTrainer(cfg, **CORPUS_TRAINER)
        run = probe._start(corpus, plat, 0)
        start = probe._resume(run, mgr)
        same = (start == cfg.max_episodes // 2
                and all(torch.equal(a, b) for a, b in zip(
                    probe.policy.parameters(), half.policy.parameters()))
                and all(torch.equal(a, b) for a, b in zip(
                    probe._opt.mu + probe._opt.nu,
                    half._opt.mu + half._opt.nu))
                and probe._opt.step == half._opt.step
                and run.sampler.state_dict() == man["sampler"]
                and np.array_equal(run.tracker.best_latencies,
                                   first.best_latencies)
                and all(np.array_equal(a, b) for a, b in zip(
                    run.tracker.best_placements, first.best_placements)))
        print(f"[corpus] resume: checkpoint of episode {start - 1} restores "
              f"params, Adam moments (step {probe._opt.step}), sampler and "
              f"tracker bitwise: {same}")
        check(same, "the restored corpus state is not what was saved")
        rest = CurriculumTrainer(cfg, **CORPUS_TRAINER)
        resumed, nr = counted(torch, lambda: rest.train_corpus(
            corpus, platform=plat, rng=0, checkpoint_dir=ckpt, resume=True))
        seq = [h["graphs"] for h in first.history + resumed.history]
        check(seq == [h["graphs"] for h in res.history],
              "the resumed run drew another graph sequence than the "
              "straight run")
        equal = all(torch.equal(a, b) for a, b in zip(
            rest.policy.parameters(), trainer.policy.parameters()))
        print(f"[corpus] resumed to episode {cfg.max_episodes - 1}: the "
              f"straight run's graph sequence; final weights bitwise the "
              f"straight run's: {equal} (not required on the card: the "
              f"atomics move the last bits); launches {nr}")

    # ---- stream: the same spec through a StreamingCorpus ----
    class Watched(StreamingCorpus):
        peak = 0

        def __getitem__(self, i):
            g = super().__getitem__(i)
            self.peak = max(self.peak, len(self._lru))
            return g

    streamed_corpus = Watched(CORPUS_FULL_SPEC, cache_graphs=2)
    st = CurriculumTrainer(HSDAGConfig(**dict(CORPUS_CONFIG,
                                              max_episodes=3)),
                           stream_cache=2, **CORPUS_TRAINER)
    rst, nst = counted(torch, lambda: st.train_corpus(
        streamed_corpus, platform=plat, rng=0))
    print(f"[corpus] stream: {[h['graphs'] for h in rst.history]}; corpus "
          f"LRU peak {streamed_corpus.peak}, trainer caches "
          f"{st.cache_peaks}; launches {nst}")
    check([h["graphs"] for h in rst.history]
          == [h["graphs"] for h in res.history[:3]],
          "the streaming run drew another graph sequence than the eager one")
    check(streamed_corpus.peak <= 2 and max(st.cache_peaks.values()) <= 2,
          "a streaming run's caches held more than 2 graphs")
    for i, g in enumerate(corpus):
        corpus_latencies_are_host(g, rst, i, plat, "[corpus] stream")
    print(f"[phase] corpus (Table 8): {time.perf_counter() - t_phase:.2f} s")
    return errs


def corpus_contract(plat, spec, record):
    """The contract's corpus pairs over ``spec``: for seeds 0-11 at
    ``CORPUS_CONTRACT_CONFIG``, the port's ``train_corpus`` (the
    reference's initial weights and graph sequence for each seed) against
    the reference's ``record``: each corpus graph's greedy latency,
    Inception-v3's and ResNet-50's best, and the two held-out graphs'
    zero-shot latency; the same test and limit as the search pairs.  → the
    smallest p-value."""
    from repro_torch import CurriculumTrainer, HSDAGConfig
    corpus, held, doc = corpus_graphs(spec, record)
    label = "full" if spec == CORPUS_FULL_SPEC else "less traced"
    names = doc["graphs"]
    seeds = doc["seeds"]
    port = collections.defaultdict(list)
    t0 = time.perf_counter()
    for s in seeds:
        trainer = CurriculumTrainer(
            HSDAGConfig(seed=s, **CORPUS_CONTRACT_CONFIG), **CORPUS_TRAINER)
        res = trainer.train_corpus(corpus, platform=plat)
        seq = [[h["bucket"], [names.index(n) for n in h["graphs"]]]
               for h in res.history]
        check(seq == doc["results"]["sequence"][str(s)],
              f"seed {s}: the port drew another graph sequence than the "
              f"reference")
        for n, lat in zip(names, res.greedy_latencies):
            port[("greedy", n)].append(float(lat))
        for n in doc["results"]["best"]:
            port[("best", n)].append(float(
                res.best_latencies[names.index(n)]))
        for g in held:
            port[("zero_shot", g.name)].append(
                trainer.evaluate_zero_shot(g, platform=plat)[1])
    print(f"[contract] corpus ({label}): {len(seeds)} corpus trainings in "
          f"{time.perf_counter() - t0:.2f} s, each seed the reference's "
          f"graph sequence")
    worst = 1.0
    for (part, name), lat in port.items():
        ref = np.array([doc["results"][part][name][str(s)] for s in seeds])
        lat = np.array(lat)
        p = one_sided_p(lat, ref)
        worst = min(worst, p)
        print(f"[contract] corpus ({label}) {part} {name}: port median "
              f"{np.median(lat) * 1e3:.6f} ms (range "
              f"{lat.min() * 1e3:.6f}-{lat.max() * 1e3:.6f}), reference "
              f"median {np.median(ref) * 1e3:.6f} ms (range "
              f"{ref.min() * 1e3:.6f}-{ref.max() * 1e3:.6f}), Mann-Whitney "
              f"p(port worse) = {p:.4g}")
        print(f"[contract] corpus ({label}) {part} {name} port ms: "
              f"{[round(float(x) * 1e3, 6) for x in lat]}")
        check(p >= CONTRACT_P,
              f"the port's corpus training ({part} {name}) is worse than "
              f"the reference's: p = {p:.3g} < {CONTRACT_P}")
    check(len(port) == len(corpus) + 4,
          f"{len(port)} corpus pairs, not {len(corpus) + 4}")
    return worst


def device_contract():
    """The contract's device-head pairs: on each fleet of
    ``TOPO_CONTRACT``, the host scheduler's latency of the best placement
    of the port's search for seeds 0-11 beside the reference's; the same
    test and limit as the paper graphs'.  → the smaller p-value."""
    from repro_torch import HSDAG, HSDAGConfig, simulate
    worst = 1.0
    topo, g, arrays, fleets = load_topology()
    for name in TOPO_CONTRACT:
        seeds = topo["seeds"]
        ref = np.array([topo["host_latency"][name][str(s)] for s in seeds])
        t0 = time.perf_counter()
        port = np.array([simulate(g, HSDAG(HSDAGConfig(
            seed=s, **TOPO_CONFIG)).search(
                g, arrays, platform=fleets[name]).best_placement,
            fleets[name]).latency for s in seeds])
        p = one_sided_p(port, ref)
        worst = min(worst, p)
        print(f"[contract] rl_device {name}: port median "
              f"{np.median(port) * 1e6:.6f} us (range "
              f"{port.min() * 1e6:.6f}-{port.max() * 1e6:.6f}), reference "
              f"median {np.median(ref) * 1e6:.6f} us (range "
              f"{ref.min() * 1e6:.6f}-{ref.max() * 1e6:.6f}), Mann-Whitney "
              f"p(port worse) = {p:.4g}; {len(seeds)} port searches in "
              f"{time.perf_counter() - t0:.2f} s")
        print(f"[contract] rl_device {name} port us: "
              f"{[round(float(x) * 1e6, 6) for x in port]}")
        check(p >= CONTRACT_P,
              f"the port's device-head search on {name} is worse than the "
              f"reference's: p = {p:.3g} < {CONTRACT_P}")
    return worst


def host_reward(g, plat):
    """The host scheduler's (reward, latency) of a placement of ``g``: the
    Table-2 drivers' ``reward_fn``."""
    from repro_torch import simulate

    def reward_fn(p):
        res = simulate(g, p, plat)
        return res.reward, res.latency
    return reward_fn


def table2_phase(torch, graphs, plat):
    """Table 2 on the card as ``benchmarks/table2_placement.py`` runs it:
    per paper graph, cpu_only, gpu_only, both OpenVINO rows, Placeto and
    the RNN placer (``TABLE2_BASELINE``, the host scheduler's reward) and
    the HSDAG row through ``PlacementSession`` (``TABLE2_HSDAG``, a host
    reward_fn, as ``benchmarks/common.py`` builds it): each row's latency,
    speedup vs cpu_only and wall time; every learned row's best latency is
    the host scheduler's for its placement, and Placeto's gcn_aggregate
    launches are what its episodes imply.  → {graph: HSDAG placement}."""
    import dataclasses
    from repro_torch import FeatureConfig, HSDAGConfig, extract_features
    from repro_torch import simulate
    from repro_torch.api import PlacementSession, PlacementSpec
    from repro_torch.core.baselines import (BaselineConfig, PlacetoBaseline,
                                            RNNBaseline, cpu_only, gpu_only,
                                            openvino_auto)
    t_phase = time.perf_counter()
    fc = FeatureConfig(**BASELINE_FEATURE)
    feature = {k: v for k, v in dataclasses.asdict(fc).items()
               if not k.endswith("_vocab")}
    cfg = BaselineConfig(**TABLE2_BASELINE)
    placements, placeto_launches = {}, 0
    for name, g in graphs.items():
        arrays = extract_features(g, fc)
        reward_fn = host_reward(g, plat)
        cpu = simulate(g, cpu_only(g), plat).latency

        def row(method, lat, wall=None):
            print(f"[table2] {name} {method}: {lat * 1e3:.6f} ms, speedup "
                  f"vs cpu_only {100 * (cpu - lat) / cpu:.2f}%"
                  + (f", wall {wall:.3f} s" if wall is not None else ""))

        def learned(method, res):
            host = simulate(g, res.best_placement, plat).latency
            check(res.best_latency == host,
                  f"table2 {name} {method}: best latency "
                  f"{res.best_latency} is not the host scheduler's {host}")
            row(method, res.best_latency, res.wall_time_s)

        row("cpu_only", cpu)
        row("gpu_only", simulate(g, gpu_only(g), plat).latency)
        for pref, label in ((0, "openvino_cpu"), (1, "openvino_gpu")):
            p, factor = openvino_auto(g, pref)
            row(label, simulate(g, p, plat).latency * factor)
        res, n = counted(torch, lambda: PlacetoBaseline(cfg).search(
            g, arrays, reward_fn, rng=cfg.seed))
        # each episode: the sampling pass, then the replay's forward and
        # backward, each through the two GCN layers
        want = cfg.episodes * 3 * 2
        check(n["gcn_aggregate"] == want,
              f"table2 {name} placeto launched gcn_aggregate "
              f"{n['gcn_aggregate']} times, not the {want} its episodes "
              f"imply")
        placeto_launches += n["gcn_aggregate"]
        learned("placeto", res)
        learned("rnn", RNNBaseline(cfg).search(g, arrays, reward_fn,
                                               rng=cfg.seed))
        session = PlacementSession(PlacementSpec(
            workload="", mode="search", feature=feature,
            config=HSDAGConfig(**TABLE2_HSDAG)))
        res = session.fit(graphs=[g], arrays=[arrays], reward_fn=reward_fn,
                          rng=TABLE2_HSDAG["seed"])
        learned("hsdag", res)
        placements[name] = res.best_placement
    print(f"[table2] Placeto's gcn_aggregate launches (B=1): "
          f"{placeto_launches}, as its episodes imply")
    print(f"[phase] table2: {time.perf_counter() - t_phase:.2f} s")
    return placements


def baseline_contract(graphs, plat):
    """The contract's learned-baseline pairs: for each paper graph and
    method, the port's best latency over seeds 0-11 at
    ``BASELINE_CONTRACT_CONFIG`` beside the reference's
    (``tools/reference_baseline_spread.json``); the same test and limit as
    the search pairs.  → the smallest p-value."""
    from repro_torch import FeatureConfig, extract_features
    from repro_torch.core.baselines import (BaselineConfig, PlacetoBaseline,
                                            RNNBaseline)
    with open(BASELINE_JSON) as f:
        doc = json.load(f)
    check(doc["config"] == BASELINE_CONTRACT_CONFIG
          and doc["feature"] == BASELINE_FEATURE,
          f"{BASELINE_JSON} holds config {doc['config']}, not "
          f"{BASELINE_CONTRACT_CONFIG}")
    methods = {"placeto": PlacetoBaseline, "rnn": RNNBaseline}
    seeds, worst = doc["seeds"], 1.0
    for name in ("inception_v3", "resnet50", "bert_base"):
        g = graphs[name]
        arrays = extract_features(g, FeatureConfig(**BASELINE_FEATURE))
        reward_fn = host_reward(g, plat)
        for method, cls in methods.items():
            ref = np.array([doc["results"][name][method][str(s)]
                            for s in seeds])
            t0 = time.perf_counter()
            port = np.array([cls(BaselineConfig(
                seed=s, **BASELINE_CONTRACT_CONFIG)).search(
                    g, arrays, reward_fn, rng=s).best_latency
                for s in seeds])
            p = one_sided_p(port, ref)
            worst = min(worst, p)
            print(f"[contract] {name} {method}: port median "
                  f"{np.median(port) * 1e3:.6f} ms (range "
                  f"{port.min() * 1e3:.6f}-{port.max() * 1e3:.6f}), "
                  f"reference median {np.median(ref) * 1e3:.6f} ms (range "
                  f"{ref.min() * 1e3:.6f}-{ref.max() * 1e3:.6f}), "
                  f"Mann-Whitney p(port worse) = {p:.4g}; {len(seeds)} "
                  f"port searches in {time.perf_counter() - t0:.2f} s")
            print(f"[contract] {name} {method} port ms: "
                  f"{[round(float(x) * 1e3, 6) for x in port]}")
            check(p >= CONTRACT_P,
                  f"the port's {method} baseline on {name} is worse than "
                  f"the reference's: p = {p:.3g} < {CONTRACT_P}")
    return worst


def table4_phase(torch, placement):
    """Table 4's measured half (``benchmarks/table4_downstream.py``):
    BERT-base executed by ``MeasuredExecutor`` on the CPU and the card
    (``devices=["cpu", "cuda"]``, warmup 1, timed 1) under cpu_only and
    under the Table-2 HSDAG placement; the measured latencies and the bytes
    of proxy weights uploaded.  The reference's accumulators start from 0,
    so every output is tanh(W·0) = 0 and its comparison cannot fail; here
    they start from ``TABLE4_FILL``, and the placed run's final output (on
    the card where the placement says) is held against the cpu_only run's
    (all on the CPU): the paper's MSE, cosine similarity and L2, at most
    ``TABLE4_TOL`` normwise and a cosine of at least ``TABLE4_CS``."""
    from repro_torch.core.executor import MeasuredExecutor
    from repro_torch.graphs import bert_base
    t_phase = time.perf_counter()
    g = bert_base()
    ex = MeasuredExecutor(g, devices=["cpu", "cuda"], warmup=1, timed=1)
    last = int(ex.order[-1])
    cpu_p = np.zeros(g.num_nodes, np.int64)
    outs, lats = [], []
    for p in (cpu_p, np.asarray(placement)):
        _, lat = ex(p)
        lats.append(lat)
        outs.append(ex.outputs(p, fill=TABLE4_FILL)[last]
                    .double().cpu().numpy())
    a, b = outs
    mse = float(np.mean((a - b) ** 2))
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    check(na > 0 and nb > 0, f"table4: a final output is zero (norms "
          f"{na:.3e} / {nb:.3e}); the comparison would measure nothing")
    cs = float(np.dot(a, b) / (na * nb))
    l2 = float(np.linalg.norm(a - b))
    rel = l2 / na
    on_gpu = int((np.asarray(placement) == 1).sum())
    print(f"[table4] bert_base executed on cpu + "
          f"{torch.cuda.get_device_name(0)}: cpu_only {lats[0] * 1e3:.3f} "
          f"ms, HSDAG placement ({on_gpu} of {g.num_nodes} nodes on the "
          f"card) {lats[1] * 1e3:.3f} ms (warmup 1, timed 1); accumulators "
          f"from {TABLE4_FILL}: final output ({a.size} values, norms "
          f"{na:.6e} / {nb:.6e}) MSE {mse:.3e}, CS {cs:.12f}, L2 {l2:.3e}, "
          f"normwise {rel:.3e} (paper: MSE 6.8e-07, CS 0.999); proxy "
          f"weights uploaded {ex.bytes_uploaded} B")
    check(rel <= TABLE4_TOL and cs >= TABLE4_CS,
          f"table4: the placed execution's output differs from cpu_only "
          f"(normwise {rel:.3g}, CS {cs:.6f})")
    print(f"[phase] table4: {time.perf_counter() - t_phase:.2f} s")


def api_phase(torch, plat):
    """The v1 API on the card: a spec's JSON round trip (equal
    ``spec_hash``), ``PlacementSession.fit`` in each mode at 2 episodes,
    each session's ``save`` → ``load`` decoding the same greedy placements
    with latencies the host scheduler's; then ``plan_stages`` of
    phi3-mini-3.8b on ``tpu_stage_platform`` beside its even split, its
    latency the host scheduler's for the projected placement."""
    import tempfile
    from repro_torch import HSDAGConfig, simulate
    from repro_torch.api import PlacementSession, PlacementSpec
    from repro_torch.configs import get
    from repro_torch.core import planner, tpu_stage_platform
    from repro_torch.core.graph import topological_order
    t_phase = time.perf_counter()
    cfg = HSDAGConfig(num_devices=2, batch_chains=8, max_episodes=2,
                      update_timestep=10)
    specs = [PlacementSpec(workload="benchmark:names=resnet50",
                           mode="search", config=cfg),
             PlacementSpec(workload="benchmark", mode="multi", config=cfg),
             PlacementSpec(workload="benchmark:names=resnet50;synthetic:"
                           "family=layered:count=3:size=30:seed=0",
                           mode="corpus", config=cfg, max_buckets=2,
                           graphs_per_episode=2)]
    for spec in specs:
        back = PlacementSpec.from_json(spec.to_json())
        check(back == spec and back.spec_hash() == spec.spec_hash(),
              f"spec round trip changed the {spec.mode} document")
        session = PlacementSession(spec)
        t0 = time.perf_counter()
        res = session.fit(rng=0)
        wall = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as d:
            session.save(d)
            loaded = PlacementSession.load(d)
        check(loaded.spec.spec_hash() == spec.spec_hash(),
              "the loaded session's spec hashes otherwise")
        lats = []
        for g in session.graphs:
            p, lat = session.evaluate(g)
            check(np.array_equal(loaded.place(g), p),
                  f"[api] {spec.mode}: the loaded session decodes {g.name} "
                  f"otherwise")
            host = simulate(g, p, plat).latency
            check(abs(lat - host) <= TOL * host,
                  f"[api] {spec.mode}: {g.name}'s latency is not the host "
                  f"scheduler's")
            lats.append(lat)
        best = getattr(res, "best_latencies", None)
        best = [res.best_latency] if best is None else list(best)
        print(f"[api] mode={spec.mode} spec_hash {spec.spec_hash()[:16]}: "
              f"fit {wall:.2f} s over {len(session.graphs)} graphs, best "
              f"{[round(float(x) * 1e3, 6) for x in best]} ms, greedy "
              f"{[round(x * 1e3, 6) for x in lats]} ms; save/load decodes "
              f"the same placements")
    t0 = time.perf_counter()
    plan = planner.plan_stages(get("phi3-mini-3.8b").config, **PLAN)
    stages = tpu_stage_platform(num_stages=PLAN["num_stages"])
    order = topological_order(plan.graph)
    proj = planner._monotone_projection(plan.stage_of_node, order,
                                        PLAN["num_stages"])
    host = simulate(plan.graph, proj, stages, order=order).latency
    print(f"[api] plan_stages phi3-mini-3.8b {PLAN}: plan "
          f"{plan.latency * 1e3:.6f} ms vs even split "
          f"{plan.baseline_latency * 1e3:.6f} ms; boundaries "
          f"{plan.boundaries}; host scheduler {host * 1e3:.6f} ms "
          f"({time.perf_counter() - t0:.2f} s)")
    check(np.array_equal(proj, plan.stage_of_node) and plan.latency == host,
          "plan_stages' latency is not the host scheduler's for its "
          "projected placement")
    print(f"[phase] api: {time.perf_counter() - t_phase:.2f} s")


def replay(server, stream):
    """Open-loop replay of ``(tenant, graph)`` requests → (placements,
    submit→settled seconds a request), as ``table11_server.py``'s."""
    done = [None] * len(stream)

    def mark(i):
        def cb(_fut):
            done[i] = time.perf_counter()
        return cb

    t_submit, futures = [], []
    for i, (tenant, g) in enumerate(stream):
        t_submit.append(time.perf_counter())
        f = server.submit(g, tenant=tenant)
        f.add_done_callback(mark(i))
        futures.append(f)
    out = [f.result(timeout=600) for f in futures]
    return out, [d - t for d, t in zip(done, t_submit)]


def service_phase(torch, plat):
    """The placement service at full width on the card: a corpus session
    (``SERVICE_CONFIG``, hidden 128) over the paper graphs and six
    synthetics, saved, then served from the checkpoint one request at a
    time (cold and warm timed apart by graph), as one ``place_many`` burst
    and through ``AsyncPlacementServer``; every placement the session's
    exactly, every ``evaluate`` latency the host scheduler's, the cold
    buckets at most the distinct buckets, ``gcn_aggregate`` launched
    ``layer_gnn`` times a request, and a second service on the same AOT
    directory with no cold bucket."""
    import tempfile
    from repro_torch import HSDAGConfig, simulate
    from repro_torch.api import (AsyncPlacementServer, PlacementService,
                                 PlacementSession, PlacementSpec)
    t_phase = time.perf_counter()
    cfg = HSDAGConfig(**SERVICE_CONFIG)
    session = PlacementSession(PlacementSpec(
        workload=SERVICE_SPEC, mode="corpus", config=cfg, **SERVICE_TRAINER))
    t0 = time.perf_counter()
    session.fit(rng=0)
    fit_s = time.perf_counter() - t0
    graphs = list(session.graphs)
    want = {g.name: session.place(g) for g in graphs}
    order = np.random.RandomState(0).permutation(SERVICE_REPEATS * len(graphs))
    stream = [graphs[i % len(graphs)] for i in order]
    per_request = cfg.layer_gnn       # one greedy step through each layer

    def same(placements, label):
        for g, p in zip(stream, placements):
            check(np.array_equal(p, want[g.name]),
                  f"[service] {label}: {g.name}'s placement is not the "
                  f"session's")

    def launches(n, label):
        check(n == {"level_makespan": 0, "sage_aggregate": 0,
                    "gcn_aggregate": per_request * len(stream)},
              f"[service] {label} launched {n}, not {per_request} "
              f"gcn_aggregate a request over {len(stream)} requests")

    with tempfile.TemporaryDirectory() as d:
        ckpt, aot_dir = os.path.join(d, "policy"), os.path.join(d, "aot")
        session.save(ckpt)
        service = PlacementService(ckpt, aot_cache=aot_dir, **SERVICE_KW)
        check(service.session.graphs == [],
              "[service] loading the checkpoint rebuilt the corpus")
        walls = {"cold": collections.defaultdict(list),
                 "warm": collections.defaultdict(list)}

        def one_at_a_time():
            out = []
            for g in stream:
                misses = service.cache_misses
                t0 = time.perf_counter()
                out.append(service.place(g))
                wall = time.perf_counter() - t0
                kind = "cold" if service.cache_misses > misses else "warm"
                walls[kind][g.name].append(wall)
            return out

        out, n = counted(torch, one_at_a_time)
        same(out, "place")
        launches(n, "one request at a time")
        for g in graphs:
            p, lat = service.evaluate(g)
            host = simulate(g, want[g.name], plat).latency
            check(np.array_equal(p, want[g.name])
                  and abs(lat - host) <= TOL * host,
                  f"[service] evaluate({g.name}) is not the session's "
                  f"placement at the host scheduler's latency")
        buckets = {service._bucket_shape(service._prepared(g).arrays)
                   for g in graphs}
        cold = len(service.shape_keys_seen)
        check(cold <= len(buckets), f"[service] {cold} cold buckets > "
                                    f"{len(buckets)} distinct buckets")
        for g in graphs:
            c, w = walls["cold"][g.name], walls["warm"][g.name]
            print(f"[service] {g.name[:28]:28s} V={g.num_nodes:4d}: cold "
                  f"{c[0] * 1e3:.3f} ms, warm {np.mean(w) * 1e3:.3f} ms "
                  f"(median {np.median(w) * 1e3:.3f}, n={len(w)})")
        all_warm = [x for w in walls["warm"].values() for x in w]
        all_cold = [x for c in walls["cold"].values() for x in c]
        print(f"[service] one at a time: {len(stream)} requests, cold mean "
              f"{np.mean(all_cold) * 1e3:.3f} ms (n={len(all_cold)}), warm "
              f"mean {np.mean(all_warm) * 1e3:.3f} ms, p50 "
              f"{np.percentile(all_warm, 50) * 1e3:.3f} ms (n="
              f"{len(all_warm)}); {n['gcn_aggregate'] / len(stream):.0f} "
              f"gcn_aggregate launches a request; cold buckets {cold} of "
              f"{len(buckets)}; fit {fit_s:.2f} s")

        t0 = time.perf_counter()
        out, n = counted(torch, lambda: service.place_many(stream))
        batched = (time.perf_counter() - t0) / len(stream)
        same(out, "place_many")
        launches(n, "place_many")
        print(f"[service] place_many: {batched * 1e3:.3f} ms a request "
              f"(batch_slots {service.batch_slots}); stats "
              f"{service.stats()}")

        with AsyncPlacementServer(batch_slots=4, max_delay_ms=5.0) as server:
            tenant = server.register(service.session)
            (out, lat), n = counted(torch, lambda: replay(
                server, [(tenant, g) for g in stream]))
            stats = server.stats()
        same(out, "AsyncPlacementServer")
        launches(n, "AsyncPlacementServer")
        print(f"[service] AsyncPlacementServer: p50 "
              f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
              f"{np.percentile(lat, 99) * 1e3:.3f} ms submit to settled; "
              f"batches full {stats['batches_full']}, deadline "
              f"{stats['batches_deadline']}, cold buckets "
              f"{stats['recompiles']}")

        fresh = PlacementService(ckpt, aot_cache=aot_dir, **SERVICE_KW)
        out = fresh.place_many(stream)
        same(out, "a fresh service on the AOT directory")
        fs = fresh.stats()
        check(fs["shape_keys_seen"] == 0 and fs["aot_decodes"] > 0,
              f"[service] a fresh service on the AOT directory decoded "
              f"cold: {fs}")
        print(f"[service] fresh service on the AOT directory: {fs}")
    print(card_line())
    print(f"[phase] service: {time.perf_counter() - t_phase:.2f} s")


def table9_phase(torch):
    """Table 9 (``benchmarks/table9_serving.py``) on the card: a policy
    fit on one synthetic mix serves another, mixed-size stream one request
    at a time (cold: a request that decoded a new bucket), then whole
    through ``place_many``; its three rows as that script derives them."""
    from repro_torch import HSDAGConfig
    from repro_torch.api import (PlacementService, PlacementSession,
                                 PlacementSpec)
    from repro_torch.graphs import build_corpus
    t_phase = time.perf_counter()
    spec = PlacementSpec(
        workload=T9_TRAIN, mode="corpus",
        config=HSDAGConfig(num_devices=2, hidden_channel=32,
                           max_episodes=min(BENCH_EPISODES, 4),
                           update_timestep=BENCH_TIMESTEP, batch_chains=4),
        max_buckets=2, graphs_per_episode=2)
    session = PlacementSession(spec)
    session.fit(rng=0)
    service = PlacementService(session, batch_slots=2, size_granularity=16)
    pool = build_corpus(SERVE_STREAM)
    stream = [pool[i % len(pool)] for i in range(T9_REQUESTS)]
    cold_walls, warm_walls, placed = [], [], []
    shapes_before = 0
    for g in stream:
        t0 = time.perf_counter()
        placed.append(service.place(g))
        wall = time.perf_counter() - t0
        shapes_now = len(service.shape_keys_seen)
        (cold_walls if shapes_now > shapes_before else warm_walls).append(
            wall)
        shapes_before = shapes_now
    recompiles = len(service.shape_keys_seen)
    cold = float(np.mean(cold_walls))
    warm = float(np.mean(warm_walls))
    buckets = sorted({service._bucket_shape(service._prepared(g).arrays)
                      for g in pool})
    check(recompiles <= len(buckets), f"[table9] {recompiles} cold buckets "
                                      f"> {len(buckets)} bucket shapes")
    print(f"[table9] serving_place_cold,{cold * 1e6:.1f},"
          f"recompiles={recompiles};bucket_shapes={len(buckets)};"
          f"buckets={'/'.join(f'{v}v{e}e' for v, e in buckets)}")
    print(f"[table9] serving_place_warm,{warm * 1e6:.1f},"
          f"speedup_vs_cold={cold / warm:.1f}x;requests={T9_REQUESTS};"
          f"cache_hits={service.cache_hits};"
          f"cache_misses={service.cache_misses}")
    t0 = time.perf_counter()
    out = service.place_many(stream)
    batched = (time.perf_counter() - t0) / len(stream)
    print(f"[table9] serving_place_batched,{batched * 1e6:.1f},"
          f"batch_slots={service.batch_slots};vs_warm={warm / batched:.1f}x;"
          f"recompiles_total={len(service.shape_keys_seen)}")
    for g, a, b in zip(stream, placed, out):
        check(np.array_equal(a, b) and np.array_equal(a, session.place(g)),
              f"[table9] {g.name}: place, place_many and the session "
              f"disagree")
    print(f"[phase] table9: {time.perf_counter() - t_phase:.2f} s")


def table11_phase(torch):
    """Table 11 (``benchmarks/table11_server.py``) on the card: two
    tenants' 100-request open-loop replay through ``AsyncPlacementServer``
    on an empty AOT directory (cold buckets ≤ distinct (tenant, bucket)
    pairs), then with fresh servers on that directory (no cold bucket);
    p50/p99 submit→settled and the batch occupancy."""
    import shutil
    import tempfile
    from repro_torch import HSDAGConfig
    from repro_torch.api import (AsyncPlacementServer, PlacementSession,
                                 PlacementSpec)
    from repro_torch.graphs import build_corpus
    t_phase = time.perf_counter()
    sessions = {}
    for t, (workload, hidden) in T11_TENANTS.items():
        sessions[t] = PlacementSession(PlacementSpec(
            workload=workload, mode="corpus",
            config=HSDAGConfig(num_devices=2, hidden_channel=hidden,
                               max_episodes=min(BENCH_EPISODES, 3),
                               update_timestep=BENCH_TIMESTEP,
                               batch_chains=2),
            max_buckets=2, graphs_per_episode=2))
        sessions[t].fit(rng=0)
    pool = build_corpus(SERVE_STREAM)
    rng = np.random.RandomState(0)
    names = sorted(sessions)
    stream_ix = [(names[rng.randint(len(names))], int(rng.randint(len(pool))))
                 for _ in range(T11_REQUESTS)]
    aot_dir = tempfile.mkdtemp(prefix="repro-torch-table11-aot-")
    replays = {}
    try:
        for label in ("cold", "warm"):
            with AsyncPlacementServer(batch_slots=4, max_delay_ms=5.0,
                                      size_granularity=16,
                                      aot_cache=aot_dir) as server:
                ids = {t: server.register(sessions[t]) for t in names}
                stream = [(ids[t], pool[i]) for t, i in stream_ix]
                pairs = len({(tid, server._tenants[tid]._bucket_shape(
                    server._tenants[tid].session.featurize(g)))
                    for tid, g in stream})
                out, walls = replay(server, stream)
                replays[label] = (out, walls, server.stats(), pairs)
    finally:
        shutil.rmtree(aot_dir, ignore_errors=True)
    out, walls, stats, pairs = replays["cold"]
    p50, p99 = np.percentile(walls, 50), np.percentile(walls, 99)
    check(stats["recompiles"] <= pairs,
          f"[table11] recompile bound violated: {stats['recompiles']} cold "
          f"buckets > {pairs} distinct (tenant, bucket) pairs")
    print(f"[table11] server_replay_cold,{p50 * 1e6:.1f},"
          f"p99_us={p99 * 1e6:.0f};requests={T11_REQUESTS};"
          f"tenants={len(names)};recompiles={stats['recompiles']};"
          f"tenant_bucket_pairs={pairs}")
    warm_out, walls, stats, _ = replays["warm"]
    w50, w99 = np.percentile(walls, 50), np.percentile(walls, 99)
    check(stats["recompiles"] == 0,
          f"[table11] warm replay decoded {stats['recompiles']} buckets cold "
          f"— the AOT preload should have served every bucket")
    print(f"[table11] server_replay_warm_aot,{w50 * 1e6:.1f},"
          f"p99_us={w99 * 1e6:.0f};recompiles=0;"
          f"aot_decodes={stats['aot_decodes']};"
          f"p99_speedup_vs_cold={p99 / w99:.1f}x")
    flushes = stats["batches_full"] + stats["batches_deadline"]
    print(f"[table11] server_batching,{stats['requests'] / max(1, flushes)},"
          f"batch_slots=4;batches_full={stats['batches_full']};"
          f"batches_deadline={stats['batches_deadline']}")
    for (t, i), a, b in zip(stream_ix, out, warm_out):
        check(np.array_equal(a, b)
              and np.array_equal(a, sessions[t].place(pool[i])),
              f"[table11] tenant {t}, {pool[i].name}: the replays and the "
              f"session disagree")
    print(f"[phase] table11: {time.perf_counter() - t_phase:.2f} s")


def sharded_child() -> int:
    """The ``[sharded]`` phase's child (``chip_smoke.py --sharded``): one
    NCCL rank on card 0 trains Table 8's corpus at ``SHARDED_CONFIG``
    unsharded, then with ``mesh_shape=(1, 1)``, each with the kernels'
    counts zeroed before and read after; the two runs must agree bit for bit
    (params, bests, greedy placements and latencies) and launch the kernels
    as often, and every best and greedy latency must be the host
    scheduler's.  Then two 1×1 runs with the episodic population, one with
    the host's float64 replay weights and one with ``update="fused"`` (the
    sharded engine's float32 weights, its PBT round and population
    gather), must agree to 1e-5 on params and launch as often.  Last, Table
    10's card row (``tools/port_table10.py``) at mesh 1×1 on this group.
    Deterministic algorithms are on, as warnings: an op without a
    deterministic CUDA version is named, and the params are then held to
    1e-5 instead."""
    import tempfile
    import warnings
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    from repro_torch import CurriculumTrainer, HSDAGConfig, paper_platform
    from repro_torch.core.sim import ShardedRolloutEngine
    from repro_torch.core.train import PopulationConfig
    from repro_torch.graphs import build_corpus
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.cuda.set_device(0)
    plat = paper_platform()
    corpus = build_corpus(CORPUS_FULL_SPEC)
    cfg = HSDAGConfig(**SHARDED_CONFIG)
    pop = PopulationConfig(cull_every=1)
    # (label, mesh, update, population)
    plan = [("None", None, "auto", None), ("(1, 1)", (1, 1), "auto", None),
            ("(1, 1) pop host", (1, 1), "host", pop),
            ("(1, 1) pop fused", (1, 1), "fused", pop)]
    runs = {}
    real_weights = ShardedRolloutEngine.window_weights
    fused_calls = [0]

    def weights(self, *a, **k):
        fused_calls[0] += 1
        return real_weights(self, *a, **k)

    ShardedRolloutEngine.window_weights = weights
    with tempfile.TemporaryDirectory() as d, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        print(f"[sharded] NCCL group of {dist.get_world_size()} rank on "
              f"{torch.cuda.get_device_name(0)} in "
              f"{time.perf_counter() - t0:.2f} s")
        try:
            for label, mesh, update, population in plan:
                trainer = CurriculumTrainer(cfg, mesh_shape=mesh,
                                            update=update,
                                            population=population,
                                            **CORPUS_TRAINER)
                fused_calls[0] = 0
                t0 = time.perf_counter()
                res, n = counted(torch, lambda: trainer.train_corpus(
                    corpus, platform=plat, rng=0))
                wall = time.perf_counter() - t0
                runs[label] = (trainer, res, n, fused_calls[0])
                walls = [round(h["wall_s"], 4) for h in res.history]
                print(f"[sharded] mesh {label}: train_corpus {wall:.3f} s, "
                      f"episode walls {walls} s, launches {n}, in-mesh "
                      f"weights {fused_calls[0]}, mesh "
                      f"{type(trainer.mesh).__name__}")
            ShardedRolloutEngine.window_weights = real_weights
            sharded_pbt_check(torch, corpus[:2], cfg, "cuda")
            torch.use_deterministic_algorithms(False)
            t10 = table10_tool()
            pps, rss_mb, wall = t10.throughput(1, 1, TABLE10_EPISODES,
                                               "cuda")
            check(np.isfinite(pps) and pps > 0,
                  f"[table10] throughput {pps} is not a positive rate")
            print(f"[table10] "
                  f"{t10.throughput_line('cuda', 1, pps, pps, rss_mb)}; "
                  f"measured wall {wall:.3f} s on an NCCL group of 1 rank")
        finally:
            ShardedRolloutEngine.window_weights = real_weights
            dist.destroy_process_group()
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})

    def max_diff(a, b):
        with torch.no_grad():
            return max(float((x - y).abs().max()) for x, y in zip(
                a.params.parameters(), b.params.parameters()))

    (ts, rs, ns, ws), (_, ru, nu, wu) = runs["(1, 1)"], runs["None"]
    check(type(ts.mesh).__name__ == "DeviceMesh",
          "[sharded] the 1x1 run did not build a DeviceMesh")
    diff = max_diff(rs, ru)
    bitwise = (diff == 0.0
               and np.array_equal(rs.best_latencies, ru.best_latencies)
               and np.array_equal(rs.greedy_latencies, ru.greedy_latencies)
               and all(np.array_equal(a, b) for a, b in zip(
                   rs.greedy_placements, ru.greedy_placements)))
    print(f"[sharded] mesh (1, 1) against None: max |dparam| {diff!r}, "
          f"bit for bit {bitwise}; ops without a deterministic CUDA "
          f"version: {nondet or 'none'}")
    if nondet:
        check(diff <= TOL, f"[sharded] params differ by {diff} > {TOL}")
    else:
        check(bitwise, "[sharded] mesh (1, 1) did not train bit for bit "
                       "like the unsharded run")
    check(ns == nu, f"[sharded] launches {ns} differ from the unsharded "
                    f"run's {nu}")
    check(ns["level_makespan"] > 0 and ns["gcn_aggregate"] > 0,
          f"[sharded] the kernels were not launched: {ns}")
    check(ws == wu == 0, f"[sharded] update='auto' ran the in-mesh weights "
                         f"({ws}, {wu} calls)")
    for i, g in enumerate(corpus):
        corpus_latencies_are_host(g, rs, i, plat, "[sharded]")
    print(f"[sharded] every best and greedy latency of the 1x1 run equals "
          f"the host scheduler's to {TOL}")
    (_, rh, nh, wh), (_, rf, nf, wf) = (runs["(1, 1) pop host"],
                                        runs["(1, 1) pop fused"])
    diff = max_diff(rf, rh)
    print(f"[sharded] population, update='fused' against the host weights: "
          f"max |dparam| {diff!r}, in-mesh weights {wf} calls")
    check(wf == SHARDED_CONFIG["max_episodes"] and wh == 0,
          f"[sharded] the in-mesh weights ran {wf} times with "
          f"update='fused' and {wh} with update='host'")
    check(diff <= TOL, f"[sharded] update='fused' params differ from the "
                       f"host weights' by {diff} > {TOL}")
    check(nf == nh, f"[sharded] update='fused' launches {nf} differ from "
                    f"the host weights' {nh}")
    check(all(h["culled"] for h in rf.history),
          "[sharded] the population did not cull every episode")
    for i, g in enumerate(corpus):
        corpus_latencies_are_host(g, rf, i, plat, "[sharded]")
    return 0


def sharded_pbt_check(torch, graphs, cfg, device):
    """The sharded engine's PBT round, which the corpus trainer's episodic
    population does not run: ``pbt_step`` (both restarts) and
    ``update_population`` on the 1×1 NCCL mesh against
    ``MultiRolloutEngine``'s, bit for bit, at ``cfg``'s width over
    ``graphs``, on the process group's ``device``."""
    from repro_torch._device import seeded_generator
    from repro_torch.core import HSDAG, extract_features
    from repro_torch.core.features import shared_feature_config
    from repro_torch.core.sim import (MultiRolloutEngine,
                                      ShardedRolloutEngine,
                                      make_rollout_mesh)
    from repro_torch.core.train import PopulationConfig
    from repro_torch.core.train.loop import make_chain_streams
    fc = shared_feature_config(graphs)
    arrays = [extract_features(g, fc) for g in graphs]
    agent = HSDAG(cfg, device=device)
    agent.init(arrays[0])
    engines = [agent.rollout_engine(a) for a in arrays]
    pop_cfg = PopulationConfig(cull_every=1)
    full = MultiRolloutEngine(engines, population=pop_cfg)
    eng = ShardedRolloutEngine(engines, num_nodes=full.num_nodes,
                               mesh=make_rollout_mesh(1, 1, device),
                               population=pop_cfg)
    B, dev = cfg.batch_chains, engines[0].x0.device
    pop = full.init_population(seeded_generator([1], dev), num_chains=B)
    zs, _, fines, _ = full.rollout_window(
        full.initial_state(B), num_steps=cfg.update_timestep,
        start_first=True, streams=make_chain_streams(3, len(graphs), B, dev))
    lat = np.random.default_rng(0).uniform(
        1, 2, (cfg.update_timestep, len(graphs), B))
    pop = full.update_population(pop, full.pad(fines), lat)
    same = torch.equal(eng.update_population(
        pop, full.pad(fines), lat).best_fine,
        full.update_population(pop, full.pad(fines), lat).best_fine)
    for greedy in (False, True):
        want_pop, want_zs = full.pbt_step(
            pop._replace(rng=seeded_generator([9], dev)), zs,
            use_greedy=greedy)
        got_pop, got_zs = eng.pbt_step(
            pop._replace(rng=seeded_generator([9], dev)), zs,
            use_greedy=greedy)
        same = same and all(torch.equal(getattr(got_pop, k),
                                        getattr(want_pop, k))
                            for k in ("temperature", "best_latency",
                                      "best_fine")) \
            and all(torch.equal(a, b) for a, b in zip(got_zs, want_zs))
    print(f"[sharded] pbt_step and update_population on the NCCL mesh "
          f"against MultiRolloutEngine's: bit for bit {same}")
    check(same, "[sharded] the sharded PBT round differs from "
                "MultiRolloutEngine's")


def sharded_phase():
    """``[sharded]``: :func:`sharded_child` in a child process, with
    ``CUBLAS_WORKSPACE_CONFIG`` set before any CUDA work; its failure fails
    the script."""
    t_phase = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--sharded"], env=env, capture_output=True,
                         text=True, timeout=600)
    for line in out.stdout.splitlines():
        print(line)
    check(out.returncode == 0, f"[sharded] the child exited "
                               f"{out.returncode}:\n{out.stderr[-3000:]}")
    print(f"[phase] sharded: {time.perf_counter() - t_phase:.2f} s")


def table10_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import port_table10
    return port_table10


def table10_phase(memory):
    """``[table10]``: ``tools/port_table10.py``'s memory rows at
    ``TABLE10_COUNTS`` graphs, whose host-only processes ``memory`` started
    before ``[sharded]``; streaming must hold less heap than the eager
    corpus.  (The card's throughput row runs in ``[sharded]``'s child, on
    its NCCL group.)"""
    t_phase = time.perf_counter()
    rows = table10_tool().collect_memory(memory)
    for (c, stream), (kb, _) in sorted(rows.items()):
        # the children's peak RSS holds this process's: the tool measures it
        print(f"[table10] {'stream' if stream else 'eager'} corpus of {c} "
              f"graphs: peak heap {kb!r} KB")
    for c in TABLE10_COUNTS:
        check(rows[(c, True)][0] < rows[(c, False)][0],
              f"[table10] the stream corpus of {c} graphs held no less "
              f"heap than the eager one")
    print(f"[phase] table10: {time.perf_counter() - t_phase:.2f} s")


def _grads(torch, fn, inputs, gout, retain=False):
    """Gradients of ``fn(*inputs)`` for the output gradient(s) ``gout``."""
    ins = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    gouts = gout if isinstance(gout, tuple) else (gout,)
    return list(torch.autograd.grad(outs, ins, gouts, retain_graph=retain))


def grad_check(torch, name, got, want, dtype, worst):
    """A backward kernel's gradients against the plain version's autograd,
    normwise: 2e-2 in bf16, 1e-5 in f32 → new worst max abs error."""
    tol = LM_TOL[str(dtype)]
    for i, (g, w) in enumerate(zip(got, want)):
        err = rel_err(torch, g.float(), w.float())
        abs_err = float((g.float() - w.float()).abs().max())
        worst = max(worst, abs_err)
        print(f"[train_kernels] {name} grad {i}: rel err {err:.3e} (tol "
              f"{tol:g}), max abs err {abs_err:.3e}")
        check(bool(torch.isfinite(g.float()).all()) and err <= tol,
              f"{name}: gradient {i} disagrees with the plain version's "
              f"autograd")
    return worst


def flash_lse_tol(n_tiles: int, lse_max: float) -> float:
    """The bound on |saved lse − torch.logsumexp| (natural log) of a row
    that visits at most ``n_tiles`` key tiles: each term of the row's sum l
    carries the relative error of the ex2.approx that made it and of each
    later rescale by alpha, one a visited tile, at most 2^-22 a call (2
    ulp); as much again for the sums' f32 rounding and log2f; and 4 ulp of
    the value for the two sides' final rounding."""
    return 2 * (n_tiles + 1) * 2.0 ** -22 + 4 * 2.0 ** -23 * lse_max


def flash_bwd_checks(torch):
    """The flash backward kernels of both routes against the plain
    version's autograd at FLASH_BWD_CASES, one (b, KV head) slice of the
    plain version at a time (the whole (B, H, S, S) f32 score tensor of
    danube's shape would take 34 GB): bf16 through the tensor-core kernels
    (csrc/flash_attention_bwd_sm90.cu), with scaled_dot_product_attention's
    backward's distance from the same plain gradients printed beside, two
    launches on the same inputs held to the same bits and the forward's
    saved log-sum-exp held to ``flash_lse_tol`` of torch.logsumexp of the
    masked f32 scores; f32 through the SIMT kernels
    (csrc/flash_attention_bwd.cu).  Then, at both bf16 shapes, the kernels'
    time beside the plain backward's and scaled_dot_product_attention's
    backward's → (worst, timing at danube's shape)."""
    import math
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention import (
        BLOCK_K, BLOCK_Q, flash_attention_backward, flash_attention_forward,
        flash_attention_work, flash_mask, flash_pairs, flash_tile_plan)
    gen = torch.Generator(device="cuda").manual_seed(21)
    routes = {"bfloat16": "wgmma_bf16", "float32": "simt_f32"}
    worst, timings = 0.0, []
    for (B, H, KV, S, D), W, dt in FLASH_BWD_CASES:
        dtype = getattr(torch, dt)
        G = H // KV
        shape = f"{(B, H, KV, S, D)} window={W} {dt}"

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(
                dtype)
        q, k, v = rnd(B, H, S, D), rnd(B, KV, S, D), rnd(B, KV, S, D)
        dout = rnd(B, H, S, D)
        before = dict(flash_attention_backward.route_launches)
        dq, dk, dv = _grads(torch, lambda q, k, v: flash_attention(
            q, k, v, window=W), [q, k, v], dout)
        check(all(flash_attention_backward.route_launches[r] == before[r]
                  + (r == routes[dt]) for r in before),
              f"the flash backward at {shape} did not launch the "
              f"{routes[dt]} kernels alone")
        want = [torch.empty_like(dq), torch.empty_like(dk),
                torch.empty_like(dv)]
        for b in range(B):
            for j in range(KV):
                hs = slice(j * G, (j + 1) * G)
                g3 = _grads(torch, lambda q, k, v: flash_attention_ref(
                    q, k, v, window=W), [q[b:b + 1, hs], k[b:b + 1, j:j + 1],
                                         v[b:b + 1, j:j + 1]],
                    dout[b:b + 1, hs])
                want[0][b, hs], want[1][b, j], want[2][b, j] = \
                    g3[0][0], g3[1][0, 0], g3[2][0, 0]
        worst = grad_check(torch, f"flash_attention backward {shape}",
                           [dq, dk, dv], want, dtype, worst)
        if dt == "float32":
            del dq, dk, dv, want
            continue
        # the yardstick: SDPA's backward against the same plain gradients,
        # normwise (max) and in the Frobenius norm, which the bf16 rounding
        # of the largest entry does not decide
        mask = flash_mask(S, True, W, "cuda")
        lib_g = _grads(torch, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), [q, k, v], dout)

        def errs(grads):
            out = []
            for g, w in zip(grads, want):
                g, w = g.float(), w.float()
                out.append(f"{rel_err(torch, g, w):.3e} / "
                           f"{float((g - w).norm() / w.norm()):.3e}")
            return ", ".join(out)
        print(f"[train_kernels] flash_attention backward {shape} against the "
              f"plain gradients, normwise / Frobenius (dq, dk, dv): the "
              f"kernels {errs((dq, dk, dv))}; scaled_dot_product_attention's "
              f"backward {errs(lib_g)}")
        del lib_g, want
        # two launches on the same inputs give the same bits
        out, lse = flash_attention_forward(q, k, v, window=W)
        again = flash_attention_backward(q, k, v, out, dout, lse, window=W)
        same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
        print(f"[train_kernels] flash_attention backward {shape}: a second "
              f"launch bit for bit: {same}")
        check(same, f"two flash backward launches at {shape} differ")
        del dq, dk, dv, again
        # the saved log-sum-exp (base 2) against torch.logsumexp, a (b, KV
        # head) slice at a time
        lse_err, lse_max = 0.0, 0.0
        for b in range(B):
            for j in range(KV):
                hs = slice(j * G, (j + 1) * G)
                sc = torch.einsum("gsd,td->gst", q[b, hs].float(),
                                  k[b, j].float()) / math.sqrt(D)
                sc.masked_fill_(~mask, -1e30)
                ref = torch.logsumexp(sc, -1)
                del sc
                lse_err = max(lse_err, float(
                    (lse[b, hs] * math.log(2) - ref).abs().max()))
                lse_max = max(lse_max, float(ref.abs().max()))
        # the key tiles the forward kernel's rows visit
        n_tiles = max(t.hi - t.lo + 1 for t in flash_tile_plan(
            S, BLOCK_Q, BLOCK_K, True, W))
        tol = flash_lse_tol(n_tiles, lse_max)
        print(f"[train_kernels] flash_attention forward {shape}: saved "
              f"log-sum-exp against torch.logsumexp of the masked f32 "
              f"scores: max abs err {lse_err:.3e} (bound {tol:.3e}: up to "
              f"{n_tiles} key tiles a row, |lse| up to {lse_max:.3f})")
        check(lse_err <= tol, f"the saved log-sum-exp at {shape} is "
              f"{lse_err:.3e} from torch.logsumexp, above {tol:.3e}")
        ms, host = cuda_ms(torch, lambda: flash_attention_backward(
            q, k, v, out, dout, lse, window=W), 3, 1)
        # the plain backward over every (b, KV head) slice, one slice's
        # graph at a time (built before its timing starts), the measured
        # times summed
        slice_ms = []
        for b in range(B):
            for j in range(KV):
                hs = slice(j * G, (j + 1) * G)
                qs = q[b:b + 1, hs].detach().requires_grad_(True)
                ks, vs = (t[b:b + 1, j:j + 1].detach().requires_grad_(True)
                          for t in (k, v))
                o1 = flash_attention_ref(qs, ks, vs, window=W)
                slice_ms.append(cuda_ms(torch, lambda: torch.autograd.grad(
                    o1, (qs, ks, vs), dout[b:b + 1, hs], retain_graph=True),
                    2, 1)[0])
                del o1, qs, ks, vs
        plain = sum(slice_ms)
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        lo = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                            enable_gqa=True)
        lib, _ = cuda_ms(torch, lambda: torch.autograd.grad(
            lo, (ql, kl, vl), dout, retain_graph=True), 3, 1)
        ms2, _ = cuda_ms(torch, lambda: flash_attention_backward(
            q, k, v, out, dout, lse, window=W), 3, 1)
        del lo, ql, kl, vl, mask
        pairs, visited = flash_pairs(S, True, W)
        # 5 products of the unmasked pairs
        ops, nbytes = flash_attention_work(B, H, KV, S, D, q.dtype,
                                           window=W, backward=True)
        b_ms, b_by = bound_ms_bf16(nbytes, ops)
        t = (min(ms, ms2), plain, b_ms, b_by, lib)
        before_ms = FLASH_BWD_SIMT_BF16_MS[len(timings)]
        print(f"[train_kernels] flash_attention backward timing {shape}: "
              f"kernels {ms:.3f} / {ms2:.3f} ms on the card (two runs around "
              f"the library's; {host:.4f} ms of host time to launch), "
              f"{ops / (t[0] * 1e-3) / 1e12:.2f} TFLOP/s on the unmasked "
              f"pairs' 5 products ({1.4 * ops / (t[0] * 1e-3) / 1e12:.2f} "
              f"on the 7 the kernels execute), {100 * b_ms / t[0]:.2f} % of "
              f"the bound; plain {plain:.3f} ms (the sum of {B * KV} (b, KV "
              f"head) slices' measured times, {min(slice_ms):.3f}-"
              f"{max(slice_ms):.3f} ms each); scaled_dot_product_attention's "
              f"backward (bool mask, enable_gqa) {lib:.3f} ms; bound "
              f"{b_ms:.6f} ms ({b_by}: {nbytes} B, {ops} ops over {pairs} "
              f"unmasked pairs per head); the SIMT kernels before: "
              f"{before_ms} ms (PERF.md)")
        check(t[0] < lib, f"the bf16 flash backward ({t[0]:.3f} ms) is not "
              f"faster than scaled_dot_product_attention's backward "
              f"({lib:.3f} ms) at {shape}")
        timings.append(t)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return worst, timings[0]


def rmsnorm_bwd_checks(torch):
    """The rmsnorm backward kernel against the plain version's autograd at
    RMS_BWD_CASES (and a ragged width), timed at danube's training rows
    beside the plain backward and F.rms_norm's → (worst, timing)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm, rmsnorm_ref, rmsnorm_work
    from repro_torch.kernels.rmsnorm import rmsnorm_backward
    gen = torch.Generator(device="cuda").manual_seed(22)
    worst, timing = 0.0, None
    for rows, d, dt in RMS_BWD_CASES + ((5, 37, "float32"),
                                        (4, 8192, "bfloat16")):
        dtype = getattr(torch, dt)
        x = (2 * torch.randn(rows, d, generator=gen, device="cuda")).to(dtype)
        scale = torch.rand(d, generator=gen, device="cuda") + 0.5
        g = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        got = _grads(torch, rmsnorm, [x, scale], g)
        want = _grads(torch, rmsnorm_ref, [x, scale], g)
        worst = grad_check(
            torch, f"rmsnorm backward {rows}x{d} {dt}", got, want, dtype,
            worst)
        if timing is None:
            ms, host = cuda_ms(torch, lambda: rmsnorm_backward(x, scale, g),
                               20)
            xr, sr = (t.detach().requires_grad_(True) for t in (x, scale))
            o = rmsnorm_ref(xr, sr)
            plain, _ = cuda_ms(torch, lambda: torch.autograd.grad(
                o, (xr, sr), g, retain_graph=True), 10)
            xl, wl = x.detach().requires_grad_(True), \
                scale.to(dtype).requires_grad_(True)
            lo = F.rms_norm(xl, (d,), wl, 1e-6)
            lib, _ = cuda_ms(torch, lambda: torch.autograd.grad(
                lo, (xl, wl), g, retain_graph=True), 20)
            ops, nbytes = rmsnorm_work(rows, d, x.dtype, backward=True)
            b_ms, b_by = bound_ms(nbytes, ops)
            timing = (ms, plain, b_ms, b_by, lib)
            print(f"[train_kernels] rmsnorm backward timing {rows}x{d} {dt}: "
                  f"kernel {ms:.4f} ms on the card ({host:.4f} ms of host "
                  f"time to launch), {100 * b_ms / ms:.1f} % of the bound; "
                  f"plain {plain:.4f} ms; F.rms_norm's backward (weight in "
                  f"{dt}) {lib:.4f} ms; bound {b_ms:.6f} ms ({b_by}: "
                  f"{nbytes} B)")
            del o, lo
        else:
            ms, _ = cuda_ms(torch, lambda: rmsnorm_backward(x, scale, g), 20)
            ops, nbytes = rmsnorm_work(rows, d, x.dtype, backward=True)
            print(f"[train_kernels] rmsnorm backward {rows}x{d} {dt}: kernel "
                  f"{ms:.4f} ms, bound {bound_ms(nbytes, ops)[0]:.6f} ms")
    return worst, timing


def ssd_bwd_checks(torch):
    """The ssd_scan reverse-scan kernel against the plain version's
    autograd at mamba2's training shape → (worst, timing)."""
    from repro_torch.kernels import ssd_scan, ssd_scan_ref, ssd_scan_work
    from repro_torch.kernels.ssd_scan import ssd_scan_backward
    gen = torch.Generator(device="cuda").manual_seed(23)
    B, C, H, P, N = SSD_BWD_SHAPE
    dec = 0.3 + 0.699 * torch.rand(B, C, H, generator=gen, device="cuda")
    dbx = torch.randn(B, C, H, P, N, generator=gen, device="cuda")
    gb = torch.randn(B, C, H, P, N, generator=gen, device="cuda")
    gf = torch.randn(B, H, P, N, generator=gen, device="cuda")
    got = _grads(torch, ssd_scan, [dec, dbx], (gb, gf))
    want = _grads(torch, ssd_scan_ref, [dec, dbx], (gb, gf))
    worst = grad_check(torch, f"ssd_scan backward {SSD_BWD_SHAPE}", got,
                       want, torch.float32, 0.0)
    del got, want
    before, _ = ssd_scan(dec, dbx)
    ms, host = cuda_ms(torch, lambda: ssd_scan_backward(dec, before, gb, gf),
                       10)
    dr, xr = (t.detach().requires_grad_(True) for t in (dec, dbx))
    o = ssd_scan_ref(dr, xr)
    plain, _ = cuda_ms(torch, lambda: torch.autograd.grad(
        o, (dr, xr), (gb, gf), retain_graph=True), 2, 1)
    del o
    ops, nbytes = ssd_scan_work(B, C, H, P, N, backward=True)
    b_ms, b_by = bound_ms(nbytes, ops)
    print(f"[train_kernels] ssd_scan backward timing {SSD_BWD_SHAPE}: kernel "
          f"{ms:.4f} ms on the card ({host:.4f} ms of host time to launch), "
          f"{100 * b_ms / ms:.1f} % of the bound; plain {plain:.3f} ms; "
          f"bound {b_ms:.6f} ms ({b_by}: {nbytes} B); no PyTorch call "
          f"computes the recurrence")
    return worst, (ms, plain, b_ms, b_by, None)


def _lm_counters():
    """The LM kernels' launch counters, forward and backward."""
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.kernels.rmsnorm import rmsnorm_backward
    from repro_torch.kernels.ssd_scan import ssd_scan_backward
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "ssd_scan": ssd_scan, "rmsnorm_bwd": rmsnorm_backward,
            "flash_attention_bwd": flash_attention_backward,
            "ssd_scan_bwd": ssd_scan_backward}


def train_phase(torch, arch, batch, seq, steps, ckpt_every, workdir):
    """Drive ``repro_torch.launch.train.main`` at full width and depth
    (bf16, remat "full"), the LM kernels' counts zeroed just before and read
    just after → (launches, the TrainResult)."""
    import math
    from repro_torch.configs import get
    from repro_torch.launch import train
    cfg = get(arch).config
    counters = _lm_counters()
    for fn in counters.values():
        fn.launches = 0
        for route in getattr(fn, "route_launches", {}):
            fn.route_launches[route] = 0
    ckpt_dir = os.path.join(workdir, arch)
    t0 = time.perf_counter()
    res = train.main(["--arch", arch, "--steps", str(steps),
                      "--global-batch", str(batch), "--seq", str(seq),
                      "--ckpt-every", str(ckpt_every), "--ckpt-dir",
                      ckpt_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    per_step = {k: n / steps for k, n in launches.items()}
    print(f"[train] {arch} {cfg.dtype} remat={cfg.remat_policy if cfg.remat else 'off'} "
          f"B={batch} S={seq} ({batch * seq} tokens a step), {steps} "
          f"steps in {wall:.2f} s: losses {res.losses}, grad norms "
          f"{res.grad_norms}, step walls {[round(w, 4) for w in res.walls]} "
          f"s, {[round(r, 1) for r in res.tok_s]} tok/s, peak "
          f"{res.peak_bytes} B ({res.peak_bytes / 2**30:.2f} GiB) "
          f"allocated; launches {launches} ({per_step} a step)")
    check(res.start == 0 and len(res.losses) == steps,
          f"{arch}: the launcher resumed or skipped steps")
    check(all(math.isfinite(x) for x in res.losses + res.grad_norms),
          f"{arch}: a loss or gradient norm is not finite")
    # random weights: the final norm's rows have unit RMS and the unembedding
    # is N(0, 0.02²), so the logits are ~N(0, σ²) with σ = 0.02·√d, whose
    # expected log-sum-exp is ln(vocab) + σ²/2 (0.51 above ln(vocab) for
    # danube's d = 2560)
    first = math.log(cfg.vocab_size) + (0.02 ** 2 * cfg.d_model) / 2
    check(abs(res.losses[0] - first) <= 0.5,
          f"{arch}: the first loss {res.losses[0]} is not within 0.5 of "
          f"ln(vocab) + σ²/2 = {first:.4f}")
    print(f"[train] {arch} first loss {res.losses[0]:.4f}: random weights "
          f"give ln(vocab) + σ²/2 = {first:.4f} (ln(vocab) "
          f"{math.log(cfg.vocab_size):.4f})")
    # per step: one forward, remat's recompute of every repeat's forward
    # (all but the final norm) and one backward
    rms = cfg.norm == "rmsnorm"
    per_fwd = rms + cfg.pattern_repeats * sum(
        rms * (1 + (f != "none" and not cfg.parallel_block)) + (m == "mamba")
        for m, f in cfg.block_pattern)
    n_attn = cfg.pattern_repeats * sum(m == "attn" for m, _ in
                                       cfg.block_pattern)
    n_mamba = cfg.pattern_repeats * sum(m == "mamba" for m, _ in
                                        cfg.block_pattern)
    want = {"rmsnorm": steps * (2 * per_fwd - rms),
            "rmsnorm_bwd": steps * per_fwd,
            "flash_attention": steps * 2 * n_attn,
            "flash_attention_bwd": steps * n_attn,
            "ssd_scan": steps * 2 * n_mamba, "ssd_scan_bwd": steps * n_mamba}
    check(launches == want, f"{arch}: the training run launched {launches}, "
          f"not the {want} the code implies")
    check(counters["flash_attention"].route_launches["wgmma_bf16"]
          == want["flash_attention"]
          and counters["flash_attention_bwd"].route_launches["wgmma_bf16"]
          == want["flash_attention_bwd"],
          f"{arch}: the bf16 run did not take the bf16 flash kernels")
    if ckpt_every:
        from repro_torch.checkpoint import CheckpointManager
        saved = CheckpointManager(ckpt_dir).all_steps()
        want_saved = sorted({s for s in range(ckpt_every, steps + 1,
                                              ckpt_every)} | {steps})[-2:]
        print(f"[train] {arch} checkpoints on disk: steps {saved}")
        check(saved == want_saved, f"{arch}: checkpoints {saved}, not "
              f"{want_saved}")
    return launches, res


def launcher_opt(steps: int):
    """The AdamW and schedule ``repro_torch.launch.train`` trains with."""
    from repro_torch.optim import adamw, linear_warmup_cosine
    return adamw(linear_warmup_cosine(3e-4, 10, steps), weight_decay=0.01)


def launcher_step(cfg, steps: int, record):
    """The launcher's train step for ``cfg`` (its optimizer and Mamba-2
    chunk), whose optimizer hands ``record`` the gradients first."""
    from repro_torch.models import make_train_step
    from repro_torch.optim import GradientTransform
    opt = launcher_opt(steps)

    def update(grads, state, params=None):
        record(grads)
        return opt.update(grads, state, params)
    return make_train_step(cfg, GradientTransform(opt.init, update),
                           ssd_chunk=32)


def tree_bytes(tree) -> int:
    from repro_torch.models.params import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def card_state_bytes(torch, arch, batch, seq, steps, res):
    """The bytes [train]'s parameters, optimizer state and gradients take on
    the card: the first two from its final state, the gradients from one
    more launcher step on that state, whose optimizer records them."""
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticTokens
    cfg = get(arch).config
    seen = {}
    step = launcher_step(cfg, steps, lambda g: seen.__setitem__(
        "grads", tree_bytes(g)))
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq, global_batch=batch,
                                      seed=11), "cuda")
    opt = res.state.opt_state
    out = {"params": tree_bytes(res.state.params),
           "opt_state": tree_bytes((opt.mu, opt.nu))}
    new, _ = step(res.state, data.batch(steps))
    del new
    out["grads"] = seen["grads"]
    return out


def dryrun_phase(torch, facts):
    """``[dryrun]``: each of TRAINS' steps dry-run by
    ``repro_torch.launch.dryrun.run_cell`` on a 1x1 fake mesh (on the host,
    no card): its parameter, gradient and optimizer-state bytes must equal
    the card's (``facts``: [train]'s bytes, walls and peak), its predicted
    peak is printed beside ``max_memory_allocated``, and its roofline bound
    (``launch/roofline.roofline_terms`` at ``HW``) must not exceed the
    measured step wall, whose ``roofline_fraction`` it prints.
    :func:`dryrun_step_child` runs meanwhile in a child process on the card
    (the dry runs hold only the host) → the child's launches."""
    import tempfile
    t_child = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    # the child's output goes to files, so that it never waits on a pipe
    # while the dry runs hold this process
    with tempfile.TemporaryFile("w+") as out, \
            tempfile.TemporaryFile("w+") as err:
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                  "--dryrun-step"], env=env, stdout=out,
                                 stderr=err, text=True)
        try:
            _dryrun_cells(facts)
            child.wait(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    for line in stdout.splitlines():
        print(line)
    check(child.returncode == 0, f"[dryrun] the step child exited "
                                 f"{child.returncode}:\n{stderr[-3000:]}")
    print(f"[dryrun] the 1x1 step's child, beside the dry runs: "
          f"{time.perf_counter() - t_child:.2f} s")
    line = [x for x in stdout.splitlines()
            if x.startswith("[dryrun] launches ")][-1]
    return json.loads(line[len("[dryrun] launches "):])


def _dryrun_cells(facts):
    """``[dryrun]``'s host half: each of TRAINS' steps on a 1x1 fake mesh
    against ``facts``, and its roofline against the measured wall."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import HW, roofline_terms
    for arch, batch, seq, steps, _ in TRAINS:
        t0 = time.perf_counter()
        f = facts[arch]
        cell = run_cell(arch, ShapeSpec(f"train_{batch}x{seq}", "train", seq,
                                        batch), mesh_shape=(1, 1),
                        optimizer=launcher_opt(steps), ssd_chunk=32)
        dry = cell["state_bytes"]
        peak = cell["memory"]["peak_bytes"]
        print(f"[dryrun] {arch} B={batch} S={seq} on a 1x1 fake mesh in "
              f"{time.perf_counter() - t0:.2f} s: params / grads / optimizer "
              f"state {dry['params']} / {dry['grads']} / {dry['opt_state']} "
              f"B, the card's {f['bytes']['params']} / {f['bytes']['grads']} "
              f"/ {f['bytes']['opt_state']} B; predicted peak {peak} B "
              f"({peak / 2**30:.2f} GiB), the card's max_memory_allocated "
              f"{f['peak']} B ({f['peak'] / 2**30:.2f} GiB), ratio "
              f"{peak / f['peak']:.3f}; kernels counted "
              f"{ {k: v['calls'] for k, v in cell['kernels'].items()} }")
        check(dry == f["bytes"], f"[dryrun] {arch}: the dry run's state "
              f"bytes {dry} are not the card's {f['bytes']}")
        r = roofline_terms(cell)
        wall = min(f["walls"][1:])
        share = r["model_flops"] / HW["peak_flops"] / wall
        print(f"[dryrun] {arch} roofline at HW (H100 SXM constants): compute "
              f"{r['compute_s'] * 1e3:.2f} ms ({cell['flops']:.4e} FLOP, "
              f"{cell['aten_flops']:.4e} of them aten ops), memory "
              f"{r['memory_s'] * 1e3:.2f} ms ({cell['bytes_accessed']:.4e} "
              f"B), collective {r['collective_s'] * 1e3:.2f} ms; bound "
              f"{r['bound_s'] * 1e3:.2f} ms ({r['dominant']}), measured "
              f"step wall {wall * 1e3:.2f} ms (the best of [train]'s steps "
              f"after the first), {100 * r['bound_s'] / wall:.1f} % of it; "
              f"6·N·D {r['model_flops']:.4e} FLOP, useful ratio "
              f"{r['useful_ratio']:.3f}; whole-step roofline_fraction "
              f"{100 * share:.2f} % of {HW['peak_flops']:.3g} FLOP/s")
        check(r["bound_s"] <= wall, f"[dryrun] {arch}: the roofline bound "
              f"{r['bound_s']} s exceeds the measured wall {wall} s")


def dryrun_step_child() -> int:
    """``[dryrun]``'s child (``chip_smoke.py --dryrun-step``): TRAINS[0]'s
    launcher step (at ``DRYRUN_STEP_CUT``) on card 0, unsharded, then on a
    1x1 mesh over a one-rank NCCL group: parameters and AdamW moments as
    DTensors (``launch.train.place_state``), the batch made by the
    pipeline's per-rank rows (``SyntheticTokens(mesh=)``), the step under
    ``use_rules`` so that every ``shard()`` lays its activation out.  The
    loss and every gradient must be bit for bit the unsharded step's, with
    the same LM kernel launches, each counted from zero.  Deterministic
    algorithms are on, as warnings, in both runs."""
    import dataclasses
    import tempfile
    import warnings
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import ShapeSpec, get
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.dryrun import _rules_for
    from repro_torch.launch.train import place_state
    from repro_torch.models import TrainState, init_params
    from repro_torch.models.params import tree_leaves
    torch.cuda.set_device(0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    arch, batch, seq, steps, _ = TRAINS[0]
    cfg = dataclasses.replace(get(arch).config, **DRYRUN_STEP_CUT)
    grads = []
    step = launcher_step(cfg, steps, grads.append)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=11)
    counters = _lm_counters()

    def run(state, batch_, rules=None, mesh=None):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        if mesh is None:
            new, met = step(state, batch_)
        else:
            with use_rules(mesh, rules):
                new, met = step(state, batch_)
        torch.cuda.synchronize()
        return (new, met, {k: fn.launches for k, fn in counters.items()},
                time.perf_counter() - t0)

    params = init_params(cfg, seed=0, device="cuda")
    state = TrainState(params, launcher_opt(steps).init(params),
                       torch.zeros((), dtype=torch.int32))
    new_u, met_u, launches_u, wall_u = run(
        state, SyntheticTokens(data, "cuda").batch(0))
    g_u = grads.pop()
    with tempfile.TemporaryDirectory() as d, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            rules = _rules_for(arch, ShapeSpec("train", "train", seq, batch),
                               False)
            placed = place_state(state, cfg, mesh, rules)
            sbatch = SyntheticTokens(data, "cuda", mesh=mesh).batch(0)
            new_s, met_s, launches_s, wall_s = run(placed, sbatch, rules,
                                                   mesh)
            g_s = grads.pop()
        finally:
            dist.destroy_process_group()
    local = (lambda t: t.to_local() if isinstance(t, DTensor) else t)
    leaves_u, leaves_s = tree_leaves(g_u), tree_leaves(g_s)
    n_dt = sum(isinstance(t, DTensor) for t in leaves_s)
    same = [torch.equal(local(a), b) for a, b in zip(leaves_s, leaves_u)]
    loss_u, loss_s = met_u["loss"], local(met_s["loss"])
    p_same = sum(torch.equal(local(a), b) for a, b in
                 zip(tree_leaves(new_s.params), tree_leaves(new_u.params)))
    nondet = sorted({str(w.message)[:120] for w in caught})
    print(f"[dryrun] {arch} step at {DRYRUN_STEP_CUT or 'full width and depth'}"
          f" B={batch} S={seq}: unsharded {wall_u:.3f} s, 1x1 NCCL mesh with "
          f"shard() active {wall_s:.3f} s; loss {float(loss_u)!r} vs "
          f"{float(loss_s)!r} (bitwise {torch.equal(loss_u, loss_s)}); "
          f"gradients bitwise in {sum(same)} of {len(same)} leaves "
          f"({n_dt} of them DTensors); parameters after the update bitwise "
          f"in {p_same} of {len(same)} leaves; launches {launches_s}, "
          f"unsharded {launches_u}; deterministic-algorithm warnings "
          f"{nondet}")
    check(n_dt == len(leaves_s), "[dryrun] the mesh step's gradients are "
          "not all DTensors")
    check(torch.equal(loss_u, loss_s), "[dryrun] the mesh step's loss is "
          "not the unsharded step's bit for bit")
    check(all(same), "[dryrun] the mesh step's gradients are not the "
          "unsharded step's bit for bit")
    check(launches_s == launches_u and all(launches_u[k] for k in (
        "rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd")),
        f"[dryrun] launches {launches_s} differ from the unsharded "
        f"{launches_u}, or a kernel was not launched")
    print(f"[dryrun] launches {json.dumps(launches_s)}")
    return 0


def train_witness_phase(torch):
    """WITNESS: whether a trajectory of the launcher's (its losses and
    gradient norms over 3 steps) comes from the kernels or from the model
    and optimizer.  The same steps run through the kernels and then, with
    the model's ``flash_attention`` and ``rmsnorm`` bound to the plain
    versions, through no kernel; before them the first batch's loss is split
    into the mean log-sum-exp of the logits and the mean label logit."""
    import dataclasses
    import math

    import repro_torch.models.layers as layers
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels import flash_attention_ref, rmsnorm_ref
    from repro_torch.models import (TrainState, forward, init_params,
                                    make_train_step)
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw, linear_warmup_cosine
    arch, cut, B, S, steps = WITNESS
    cfg = dataclasses.replace(get(arch).config, **cut)
    where = (f"dataclasses.replace(config, "
             f"{', '.join(f'{k}={v!r}' for k, v in cut.items())})" if cut
             else "the full config")
    print(f"[train_witness] {arch}: {where}, {cfg.dtype}, "
          f"{cfg.n_layers} layers, remat "
          f"{cfg.remat_policy if cfg.remat else 'off'}, B={B} S={S}, "
          f"{steps} steps of adamw(linear_warmup_cosine(3e-4, 10, {steps}), "
          f"weight_decay=0.01), data seed 11")
    params = init_params(cfg, seed=0, device="cuda")
    data = SyntheticTokens(DataConfig(cfg.vocab_size, S, B, seed=11), "cuda")
    batches = [data.batch(i) for i in range(steps)]
    with torch.no_grad():
        logits = forward(params, cfg, batches[0]["tokens"]).float()
        lse = float(torch.logsumexp(logits, -1).mean())
        label = float(logits.gather(
            -1, batches[0]["labels"].long()[..., None]).mean())
        var = float(logits.var(-1).mean())
        del logits
    print(f"[train_witness] first batch's loss {lse - label:.4f} = mean "
          f"log-sum-exp {lse:.4f} - mean label logit {label:.4f}; the "
          f"logits' variance over the vocabulary {var:.4f} (0.02² · d = "
          f"{0.02 ** 2 * cfg.d_model:.4f}), ln(vocab) + var/2 = "
          f"{math.log(cfg.vocab_size) + var / 2:.4f}")
    check(abs(lse - math.log(cfg.vocab_size) - var / 2) <= WITNESS_LSE_TOL,
          f"{arch}: the first batch's mean log-sum-exp {lse} is not within "
          f"{WITNESS_LSE_TOL} of ln(vocab) + var/2")
    opt = adamw(linear_warmup_cosine(3e-4, 10, steps), weight_decay=0.01)
    step_fn = make_train_step(cfg, opt, ssd_chunk=32)
    counters = _lm_counters()

    def run():
        p = tree_map(torch.clone, params)
        st = TrainState(p, opt.init(p), torch.zeros((), dtype=torch.int32))
        before = {k: fn.launches for k, fn in counters.items()}
        losses, norms = [], []
        for b in batches:
            st, m = step_fn(st, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        return losses, norms, {k: fn.launches - before[k]
                               for k, fn in counters.items()}

    t0 = time.perf_counter()
    k_loss, k_norm, k_launch = run()
    k_s = time.perf_counter() - t0
    bound = layers.flash_attention, layers.rmsnorm
    layers.flash_attention = flash_attention_ref
    layers.rmsnorm = rmsnorm_ref
    try:
        t0 = time.perf_counter()
        p_loss, p_norm, p_launch = run()
        p_s = time.perf_counter() - t0
    finally:
        layers.flash_attention, layers.rmsnorm = bound
    print(f"[train_witness] kernels ({k_s:.2f} s): losses {k_loss}, grad "
          f"norms {k_norm}; launches {k_launch}")
    print(f"[train_witness] plain versions ({p_s:.2f} s): losses {p_loss}, "
          f"grad norms {p_norm}; launches {p_launch}")
    d_loss = [abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss)]
    d_norm = [abs(a - b) / abs(b) for a, b in zip(k_norm, p_norm)]
    print(f"[train_witness] kernels vs plain, relative, a step: loss "
          f"{[f'{d:.3e}' for d in d_loss]}, grad norm "
          f"{[f'{d:.3e}' for d in d_norm]} (bound {WITNESS_TOL:g})")
    check(k_launch["flash_attention_bwd"] == steps * cfg.n_layers
          and not any(p_launch.values()),
          f"{arch}: the witness's kernel run launched {k_launch}, its plain "
          f"run {p_launch}")
    check(max(d_loss + d_norm) <= WITNESS_TOL,
          f"{arch}: the kernels' trajectory is not the plain versions'")


def _capture(opt):
    """``opt`` that keeps the (clipped) gradients each update receives."""
    from repro_torch.optim import GradientTransform
    seen = {}

    def update(grads, state, params=None):
        seen["grads"] = grads
        return opt.update(grads, state, params)
    return GradientTransform(opt.init, update), seen


def train_parity_phase(torch, workdir):
    """The card's train step (kernels) against the port's CPU train step
    (plain versions) at 2 layers of full width in float32, then grad
    accumulation and remat on the card, and a resume through an async
    checkpoint."""
    import dataclasses
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import TrainState, init_params, make_train_step
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import adamw, linear_warmup_cosine
    f32 = torch.float32
    for arch, cut, B, S in PARITY:
        t_arch = time.perf_counter()
        cfg = dataclasses.replace(get(arch).config, **cut)
        print(f"[train_parity] {arch} cut: dataclasses.replace(config, "
              f"{', '.join(f'{k}={v!r}' for k, v in cut.items())}), B={B} "
              f"S={S}, ssd_chunk=32")
        params = init_params(cfg, seed=0, device="cpu")
        data = SyntheticTokens(DataConfig(cfg.vocab_size, S, B, seed=11),
                               "cpu")
        batches = [data.batch(i) for i in range(3)]
        opt = adamw(linear_warmup_cosine(3e-4, 10, 100), weight_decay=0.01)

        def run(dev, c, batch):
            p = tree_map(lambda a: a.to(dev), params)
            o, seen = _capture(opt)
            st, m = make_train_step(c, o, ssd_chunk=32)(
                TrainState(p, opt.init(p), torch.zeros((), dtype=torch.int32)),
                {k: v.to(dev) for k, v in batch.items()})
            return m, tree_leaves(seen["grads"]), st

        t0 = time.perf_counter()
        m_cpu, g_cpu, _ = run("cpu", cfg, batches[0])
        cpu_s = time.perf_counter() - t0
        m_card, g_card, _ = run("cuda", cfg, batches[0])
        torch.cuda.synchronize()
        errs = [rel_err(torch, a.cpu(), b) for a, b in zip(g_card, g_cpu)]
        l_card, l_cpu = float(m_card["loss"]), float(m_cpu["loss"])
        n_card, n_cpu = float(m_card["grad_norm"]), float(m_cpu["grad_norm"])
        print(f"[train_parity] {arch} card vs CPU (one step; the CPU's took "
              f"{cpu_s:.2f} s): loss {l_card!r} vs {l_cpu!r} (rel "
              f"{abs(l_card - l_cpu) / l_cpu:.3e}), grad norm {n_card!r} vs "
              f"{n_cpu!r}; gradient leaves normwise: worst {max(errs):.3e}, "
              f"median {sorted(errs)[len(errs) // 2]:.3e} over {len(errs)} "
              f"leaves (bound {PARITY_GRAD_TOL:g})")
        check(abs(l_card - l_cpu) <= 1e-5 * l_cpu
              and abs(n_card - n_cpu) <= 1e-5 * n_cpu,
              f"{arch}: the card's loss or gradient norm is not the CPU's")
        check(max(errs) <= PARITY_GRAD_TOL,
              f"{arch}: a gradient leaf on the card is {max(errs):.3e} from "
              f"the CPU's")
        del g_cpu
        # the same step again: which leaves are not the same bits (atomics)
        _, g_again, _ = run("cuda", cfg, batches[0])
        differ = [i for i, (a, b) in enumerate(zip(g_card, g_again))
                  if not torch.equal(a, b)]
        shapes = [tuple(g_card[i].shape) for i in differ]
        print(f"[train_parity] {arch} the card's step twice: {len(differ)} "
              f"of {len(g_card)} gradient leaves differ in some bit"
              + (f" (shapes {shapes})" if differ else
                 " (the step is deterministic: the backward kernels use no "
                 "atomics)"))
        del g_again
        # grad accumulation: 2 microbatches against the whole batch
        m_acc, g_acc, _ = run("cuda", dataclasses.replace(cfg, grad_accum=2),
                              batches[0])
        e_acc = max(rel_err(torch, a, b) for a, b in zip(g_acc, g_card))
        l_acc = float(m_acc["loss"])
        print(f"[train_parity] {arch} grad_accum=2 vs 1: loss {l_acc!r} vs "
              f"{l_card!r} (rel {abs(l_acc - l_card) / l_card:.3e}), "
              f"gradients worst {e_acc:.3e} normwise")
        # the halves' products and sums run at another batch size, so in
        # another order: the card-vs-CPU bound
        check(abs(l_acc - l_card) <= 1e-6 * l_card
              and e_acc <= PARITY_GRAD_TOL,
              f"{arch}: grad_accum=2 disagrees with grad_accum=1")
        del g_acc
        # remat "full" and "dots" against none
        for policy in ("full", "dots"):
            m_r, g_r, _ = run("cuda", dataclasses.replace(
                cfg, remat=True, remat_policy=policy), batches[0])
            e_r = max(rel_err(torch, a, b) for a, b in zip(g_r, g_card))
            same = sum(torch.equal(a, b) for a, b in zip(g_r, g_card))
            print(f"[train_parity] {arch} remat {policy!r} vs none: loss "
                  f"{float(m_r['loss'])!r} vs {l_card!r}, gradients worst "
                  f"{e_r:.3e} normwise, {same} of {len(g_r)} leaves bitwise")
            check(float(m_r["loss"]) == l_card and e_r <= 1e-6,
                  f"{arch}: remat {policy!r} changed the step")
            del g_r
        del g_card
        if arch != "mamba2-130m":
            print(f"[phase] train_parity {arch}: "
                  f"{time.perf_counter() - t_arch:.2f} s")
            continue
        # resume: three straight steps, an async save after the second;
        # the restored state bitwise, then its third step
        step = make_train_step(cfg, opt, ssd_chunk=32)
        dev = [{n: v.cuda() for n, v in b.items()} for b in batches]
        p = tree_map(lambda a: a.cuda(), params)
        st = TrainState(p, opt.init(p), torch.zeros((), dtype=torch.int32))
        mgr = CheckpointManager(os.path.join(workdir, "parity"), keep=2,
                                async_save=True)
        losses = []
        for i in range(3):
            st, m = step(st, dev[i])
            losses.append(float(m["loss"]))
            if i == 1:
                saved = st
                mgr.save(2, st)
        mgr.wait()
        mgr.close()
        fresh = tree_map(torch.zeros_like, saved)
        restored = CheckpointManager(os.path.join(workdir, "parity")) \
            .restore(2, fresh)
        bitwise = all(a.dtype == b.dtype and a.shape == b.shape
                      and torch.equal(a, b) for a, b in
                      zip(tree_leaves(restored), tree_leaves(saved)))
        st3, m3 = step(restored, dev[2])
        l3 = float(m3["loss"])
        same_params = sum(torch.equal(a, b) for a, b in
                          zip(tree_leaves(st3.params), tree_leaves(st.params)))
        n_params = len(tree_leaves(st.params))
        print(f"[train_parity] {arch} resume: restored state bitwise "
              f"{bitwise} ({len(tree_leaves(saved))} leaves, step "
              f"{int(restored.step)}), third loss {l3!r} vs the straight "
              f"run's {losses[2]!r} (bitwise {l3 == losses[2]}, rel "
              f"{abs(l3 - losses[2]) / losses[2]:.3e}); params after it "
              f"bitwise in {same_params} of {n_params} leaves")
        check(bitwise, f"{arch}: the restored state is not the saved one")
        check(abs(l3 - losses[2]) <= 1e-6 * losses[2],
              f"{arch}: the resumed third loss disagrees")
        print(f"[phase] train_parity {arch}: "
              f"{time.perf_counter() - t_arch:.2f} s")


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
    from repro_torch import (HSDAGConfig, PAPER_BENCHMARKS, extract_features,
                             paper_platform, simulate)
    from repro_torch.core.sim import LevelBackend
    from repro_torch.kernels._build import build_all, build_dir
    from repro_torch.kernels.rmsnorm import rmsnorm_launch_plan

    t_start = time.perf_counter()
    # Full float32 everywhere: the checks below compare at 1e-5.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"card: {card}; allow_tf32 off for matmul and cuDNN")

    t0 = time.perf_counter()
    # the bf16 forward as it was before the cap (tools/flash_fwd_bitwise.py
    # holds the uncapped path bit for bit against it) builds beside them
    import threading
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import flash_fwd_bitwise
    old_build = threading.Thread(target=flash_fwd_bitwise.build_old,
                                 args=(flash_fwd_bitwise.UNCAPPED,))
    old_build.start()
    built = build_all()
    old_build.join()
    print(f"[build] {time.perf_counter() - t0:.2f} s wall, nvcc per source "
          f"{ {k: round(v, 2) for k, v in built.items()} } into "
          f"{build_dir()}")
    for log in sorted(build_dir().glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {log.stem}: {line.strip()}")
    flash_sm90_report()
    level_build_report()

    plat = paper_platform()
    graphs = {name: build() for name, build in PAPER_BENCHMARKS.items()}
    lvl_err, lvl_t = level_checks(torch, graphs, plat)
    scan_err, scan_t = scan_checks(torch, graphs, plat)
    gcn_err, gcn_t = gcn_checks(torch, graphs)
    sage_err, sage_t = sage_checks(torch, graphs)

    # ---- the main path: search with the default engine (the scan
    # reward), then greedy place(); then the level engine's path ----
    t_phase = time.perf_counter()
    g = graphs["inception_v3"]
    arrays = extract_features(g)
    res, placement, launches = search_phase(
        torch, g, arrays, plat, HSDAGConfig(batch_chains=16, max_episodes=3))
    check(launches["level_makespan"] >= 3,
          "the search scored no window through the level kernel")
    host = simulate(g, res.best_placement, plat).latency
    print(f"[search] best placement on the host scheduler (default order): "
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

    t_phase = time.perf_counter()
    lres, _, level_launches = search_phase(
        torch, g, arrays, plat,
        HSDAGConfig(batch_chains=16, engine="level", max_episodes=1))
    check(level_launches["level_makespan"] >= 1,
          "the level search scored no window through the level kernel")
    order = LevelBackend(device="cuda").prepare(g, plat).arrays.order
    host = simulate(g, lres.best_placement, plat, order=order).latency
    print(f"[search] level engine: best placement on the host scheduler "
          f"(level order): {host * 1e3:.6f} ms vs kernel "
          f"{lres.best_latency * 1e3:.6f} ms")
    check(abs(lres.best_latency - host) <= TOL * host,
          "the level search's best latency disagrees with the host "
          "scheduler")
    print(f"[phase] search, engine='level': "
          f"{time.perf_counter() - t_phase:.2f} s")

    # ---- the search's other paths, the device head, Table 13, then the
    # quality contract ----
    sage_launches = slice_phases(torch, g, arrays, plat)
    device_head_phase(torch, g, arrays)
    capacity_phase(torch, g, arrays)
    topology_phase(torch)
    # ---- Table 2 (its learned baselines and the HSDAG row through the
    # session), Table 4 on its BERT-base placement ----
    table2_placements = table2_phase(torch, graphs, plat)
    table4_phase(torch, table2_placements["bert_base"])
    t_phase = time.perf_counter()
    contract_p = contract_phase(graphs, plat)
    print(f"[phase] contract (96 port searches, 24 joint trainings, 24 "
          f"corpus trainings, 72 learned-baseline searches): "
          f"{time.perf_counter() - t_phase:.2f} s; smallest p "
          f"{contract_p:.4g}")
    multi_phase(torch, graphs, plat)
    corpus_lvl_err, corpus_gcn_err = corpus_phase(torch, plat)
    api_phase(torch, plat)
    # ---- the placement service, Tables 9 and 11 ----
    service_phase(torch, plat)
    table9_phase(torch)
    table11_phase(torch)
    # ---- the sharded corpus trainer and Table 10 (its memory rows are
    # host-only processes, run beside [sharded]'s child) ----
    t_phase = time.perf_counter()
    memory = table10_tool().start_memory(TABLE10_COUNTS)
    try:
        sharded_phase()
        table10_phase(memory)
    finally:
        for proc in memory.values():
            if proc.poll() is None:
                proc.kill()
    print(f"[phase] sharded + table10: {time.perf_counter() - t_phase:.2f} "
          f"s")

    # ---- the LM kernels against their plain versions ----
    t_phase = time.perf_counter()
    rms_err, rms_t, rms_shapes = rmsnorm_checks(torch)
    (flash_err, flash_t, flash96_err, flash96_t, flash128_err,
     flash128_t) = flash_checks(torch)
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
        served[arch], _ = serve_phase(torch, arch, batch, prompt, steps)
        torch.cuda.empty_cache()
        want = sum(n for a, *_, n in rms_shapes if a == arch)
        check(served[arch]["rmsnorm"] == want,
              f"{arch} serve launched rmsnorm {served[arch]['rmsnorm']} "
              f"times, not the {want} its timing counted")
        # prefill's norms on the warp route, decode's 4-row ones on the
        # block route, as the plan says
        want_routes = dict.fromkeys(served[arch]["rmsnorm_routes"], 0)
        for a, rows, d, dtype, n in rms_shapes:
            if a == arch:
                want_routes[rmsnorm_launch_plan(rows, d, dtype).route] += n
        check(served[arch]["rmsnorm_routes"] == want_routes,
              f"{arch} serve's rmsnorm launches per route "
              f"{served[arch]['rmsnorm_routes']} are not the plan's "
              f"{want_routes}")
    danube, mamba = served["h2o-danube-1.8b"], served["mamba2-130m"]
    phi3 = served["phi3-mini-3.8b"]
    print(f"[phase] serve: {time.perf_counter() - t_phase:.2f} s")

    # ---- decode consistency at full width, float32, TF32 off ----
    t_phase = time.perf_counter()
    decode_consistency(torch, "h2o-danube-1.8b", 200, 8)
    torch.cuda.empty_cache()
    decode_consistency(torch, "mamba2-130m", 200, 8)
    torch.cuda.empty_cache()
    decode_consistency(torch, "phi3-mini-3.8b", 200, 8)
    print(f"[phase] decode consistency: {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()

    # ---- the other six archs in bf16: olmoe-1b-7b (this slice's main
    # path) and musicgen-medium at full depth, the others cut to one card;
    # then each one's decode consistency in float32 ----
    import dataclasses
    from repro_torch.configs import get
    t_phase = time.perf_counter()
    # warm-up of the MoE path (cuBLAS's batched products) before the
    # counted runs
    serve.serve(dataclasses.replace(get("olmoe-1b-7b").config, n_layers=1),
                1, 128, 2)
    torch.cuda.empty_cache()
    arch_served = {}
    for arch, batch, prompt, steps, cut in ARCH_SERVES:
        t_arch = time.perf_counter()
        with MoEDrops(min_tokens=batch * prompt) as drops:
            arch_served[arch], res = serve_phase(torch, arch, batch, prompt,
                                                 steps, cut)
        if drops.calls:
            print(f"[serve] {arch} bf16 prefill at capacity_factor "
                  f"{get(arch).config.capacity_factor}: {drops.total()} of "
                  f"{drops.assignments} (token, choice) assignments dropped "
                  f"over its {drops.calls} MoE layers; weights "
                  f"{res.weight_bytes} B ({res.weight_bytes / 2**30:.3f} "
                  f"GiB) on the card")
        del res
        torch.cuda.empty_cache()
        print(f"[phase] serve {arch}: {time.perf_counter() - t_arch:.2f} s")
    olmoe = arch_served["olmoe-1b-7b"]
    print(f"[phase] six-arch serves: {time.perf_counter() - t_phase:.2f} s")
    t_phase = time.perf_counter()
    for arch, *_, cut in ARCH_SERVES:
        # internvl2's prompt runs past its 256 vision tokens
        decode_consistency(torch, arch, 300 if arch == "internvl2-76b"
                           else 200, 8, cut=CONSISTENCY_CUTS.get(arch, cut))
        torch.cuda.empty_cache()
    print(f"[phase] six-arch decode consistency: "
          f"{time.perf_counter() - t_phase:.2f} s")

    # ---- LM training: the backward kernels against their plain versions'
    # autograd, the launcher at full width and depth (this slice's main
    # path), then the card's step against the port's CPU step ----
    import tempfile
    t_phase = time.perf_counter()
    fbwd_err, fbwd_t = flash_bwd_checks(torch)
    rbwd_err, rbwd_t = rmsnorm_bwd_checks(torch)
    sbwd_err, sbwd_t = ssd_bwd_checks(torch)
    torch.cuda.empty_cache()
    print(f"[phase] train_kernels: {time.perf_counter() - t_phase:.2f} s")
    with tempfile.TemporaryDirectory() as workdir:
        t_phase = time.perf_counter()
        trained, facts = {}, {}
        for arch, batch, seq, steps, every in TRAINS:
            t_arch = time.perf_counter()
            trained[arch], res = train_phase(torch, arch, batch, seq, steps,
                                             every, workdir)
            facts[arch] = {"walls": res.walls, "peak": res.peak_bytes}
            facts[arch]["bytes"] = card_state_bytes(torch, arch, batch, seq,
                                                    steps, res)
            del res
            torch.cuda.empty_cache()
            print(f"[phase] train {arch}: {time.perf_counter() - t_arch:.2f}"
                  f" s")
        print(f"[phase] train: {time.perf_counter() - t_phase:.2f} s")
        t_phase = time.perf_counter()
        mesh_launches = dryrun_phase(torch, facts)
        print(f"[phase] dryrun: {time.perf_counter() - t_phase:.2f} s")
        t_phase = time.perf_counter()
        train_witness_phase(torch)
        torch.cuda.empty_cache()
        print(f"[phase] train_witness: {time.perf_counter() - t_phase:.2f} "
              f"s")
        t_phase = time.perf_counter()
        train_parity_phase(torch, workdir)
        torch.cuda.empty_cache()
        print(f"[phase] train_parity: {time.perf_counter() - t_phase:.2f} s")
    tdanube, tmamba = trained["h2o-danube-1.8b"], trained["mamba2-130m"]

    # ---- the logit softcap: the four capped kernels against their plain
    # versions, the uncapped bf16 forward bit for bit as it was before the
    # cap, then the capped main paths (danube's serve and training steps,
    # its f32 decode consistency); int8 weights; merged heads ----
    t_phase = time.perf_counter()
    cap_err, cap_t, cap_bwd_err, cap_bwd_t = softcap_checks(torch)
    torch.cuda.empty_cache()
    check(flash_fwd_bitwise.main([]) == 0, "the uncapped bf16 flash forward "
          "is not bit for bit the kernel before the cap, or a capped launch "
          "failed")
    print(f"[phase] softcap kernels: {time.perf_counter() - t_phase:.2f} s")
    t_phase = time.perf_counter()
    cap_launches, res = softcap_serve_phase(torch)
    del res
    torch.cuda.empty_cache()
    cap_bwd_launches, _ = softcap_train_phase(torch)
    torch.cuda.empty_cache()
    decode_consistency(torch, "h2o-danube-1.8b", 200, 8,
                       cut={"attn_logit_softcap": SOFTCAP_CONSISTENCY})
    torch.cuda.empty_cache()
    print(f"[phase] softcap main paths: {time.perf_counter() - t_phase:.2f} "
          f"s")
    t_phase = time.perf_counter()
    quantize_phase(torch)
    torch.cuda.empty_cache()
    print(f"[phase] quantize: {time.perf_counter() - t_phase:.2f} s")
    t_phase = time.perf_counter()
    head_merge_phase(torch)
    torch.cuda.empty_cache()
    print(f"[phase] head_merge: {time.perf_counter() - t_phase:.2f} s")

    kernels = [
        {"name": "level_makespan", "route": "cuda",
         "source": "src/repro_torch/csrc/levelsim.cu",
         "replaces": "src/repro/kernels/levelsim.py:131",
         "launches": level_launches["level_makespan"],
         "max_abs_err": lvl_err, "ms": lvl_t[0], "plain_ms": lvl_t[1],
         "bound_ms": lvl_t[2], "bound_by": lvl_t[3], "library_ms": None},
        {"name": "node_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/levelsim.cu",
         "replaces": "src/repro/core/costmodel.py:498 (simulate_jax, a "
                     "lax.scan; no Pallas source)",
         "launches": launches["level_makespan"],
         "max_abs_err": max(scan_err, corpus_lvl_err),
         "ms": scan_t[0], "plain_ms": scan_t[1], "bound_ms": scan_t[2],
         "bound_by": scan_t[3], "library_ms": None},
        {"name": "gcn_aggregate", "route": "cuda",
         "source": "src/repro_torch/csrc/gcn_spmm.cu",
         "replaces": "src/repro/kernels/gcn_spmm.py:31",
         "launches": launches["gcn_aggregate"],
         "max_abs_err": max(gcn_err, corpus_gcn_err),
         "ms": gcn_t[0], "plain_ms": gcn_t[1], "bound_ms": gcn_t[2],
         "bound_by": gcn_t[3], "library_ms": gcn_t[4]},
        {"name": "sage_aggregate", "route": "cuda",
         "source": "src/repro_torch/csrc/gcn_spmm.cu",
         "replaces": "src/repro/core/gnn.py:121 (the SAGE neighbour mean, "
                     "a dense product; no Pallas source)",
         "launches": sage_launches["sage_aggregate"],
         "max_abs_err": sage_err, "ms": sage_t[0], "plain_ms": sage_t[1],
         "bound_ms": sage_t[2], "bound_by": sage_t[3],
         "library_ms": sage_t[4]},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:24",
         "launches": danube["rmsnorm"] + mamba["rmsnorm"] + phi3["rmsnorm"]
         + sum(a["rmsnorm"] for a in arch_served.values())
         + mesh_launches["rmsnorm"],
         "max_abs_err": rms_err, "ms": rms_t[0], "plain_ms": rms_t[1],
         "bound_ms": rms_t[2], "bound_by": rms_t[3], "library_ms": rms_t[4]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:35",
         "launches": danube["wgmma_bf16"] + mamba["wgmma_bf16"]
         + mesh_launches["flash_attention"],
         "max_abs_err": flash_err, "ms": flash_t[0], "plain_ms": flash_t[1],
         "bound_ms": flash_t[2], "bound_by": flash_t[3],
         "library_ms": flash_t[4]},
        {"name": "flash_attention (D=96, phi3-mini prefill)",
         "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:35",
         "launches": phi3["wgmma_bf16"],
         "max_abs_err": flash96_err, "ms": flash96_t[0],
         "plain_ms": flash96_t[1], "bound_ms": flash96_t[2],
         "bound_by": flash96_t[3], "library_ms": flash96_t[4]},
        {"name": "flash_attention (D=128, olmoe-1b-7b prefill)",
         "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:35",
         "launches": olmoe["wgmma_bf16"],
         "max_abs_err": flash128_err, "ms": flash128_t[0],
         "plain_ms": flash128_t[1], "bound_ms": flash128_t[2],
         "bound_by": flash128_t[3], "library_ms": flash128_t[4]},
        {"name": f"flash_attention (softcap {SOFTCAP:g}, danube prefill)",
         "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:35 with "
                     "src/repro/models/layers.py:134 (_gqa_scores' softcap; "
                     "the Pallas kernel has none)",
         "launches": cap_launches, "max_abs_err": cap_err,
         "ms": cap_t[0], "plain_ms": cap_t[1], "bound_ms": cap_t[2],
         "bound_by": cap_t[3], "library_ms": cap_t[4]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:27",
         "launches": danube["ssd_scan"] + mamba["ssd_scan"]
         + phi3["ssd_scan"] + sum(a["ssd_scan"] for a in arch_served.values()),
         "max_abs_err": ssd_err, "ms": ssd_t[0], "plain_ms": ssd_t[1],
         "bound_ms": ssd_t[2], "bound_by": ssd_t[3], "library_ms": ssd_t[4]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:35 (its "
                     "gradient; the Pallas kernel has no backward)",
         "launches": tdanube["flash_attention_bwd"]
         + mesh_launches["flash_attention_bwd"],
         "max_abs_err": fbwd_err, "ms": fbwd_t[0], "plain_ms": fbwd_t[1],
         "bound_ms": fbwd_t[2], "bound_by": fbwd_t[3],
         "library_ms": fbwd_t[4]},
        {"name": f"flash_attention_bwd (softcap {SOFTCAP:g}, danube "
                 f"training)", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:35 (its gradient, "
                     "with src/repro/models/layers.py:134's softcap; the "
                     "Pallas kernel has neither)",
         "launches": cap_bwd_launches, "max_abs_err": cap_bwd_err,
         "ms": cap_bwd_t[0], "plain_ms": cap_bwd_t[1],
         "bound_ms": cap_bwd_t[2], "bound_by": cap_bwd_t[3],
         "library_ms": cap_bwd_t[4]},
        {"name": "rmsnorm_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:24 (its gradient; the "
                     "Pallas kernel has no backward)",
         "launches": tdanube["rmsnorm_bwd"] + tmamba["rmsnorm_bwd"]
         + mesh_launches["rmsnorm_bwd"],
         "max_abs_err": rbwd_err, "ms": rbwd_t[0], "plain_ms": rbwd_t[1],
         "bound_ms": rbwd_t[2], "bound_by": rbwd_t[3],
         "library_ms": rbwd_t[4]},
        {"name": "ssd_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:27 (its gradient; the "
                     "Pallas kernel has no backward)",
         "launches": tmamba["ssd_scan_bwd"],
         "max_abs_err": sbwd_err, "ms": sbwd_t[0], "plain_ms": sbwd_t[1],
         "bound_ms": sbwd_t[2], "bound_by": sbwd_t[3],
         "library_ms": sbwd_t[4]},
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
        child = {"--sharded": sharded_child,
                 "--dryrun-step": dryrun_step_child}.get(
                     " ".join(sys.argv[1:]))
        sys.exit(child() if child else main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
