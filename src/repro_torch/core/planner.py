"""Production planner: HSDAG placement of LM layer graphs onto stages.

Port of ``repro/core/planner.py``.  :func:`layer_graph` is the graph of an
architecture's layers (embed, one node per mixer and FFN, unembed) with
flops and bytes derived analytically from its :class:`ModelConfig` and input
shape (an MoE layer costs its top-k experts and the router); the corpus's
``lm`` workload provider places these graphs.

:func:`plan_stages` is the paper's technique in its production slot: the
"devices" are pipeline stages (``tpu_stage_platform``, the reference's
simulated pods), the reward is the host scheduler's makespan of the
placement projected to contiguous stages, and the search is the unchanged
HSDAG loop, on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..models.config import ModelConfig
from .costmodel import simulate, tpu_stage_platform
from .features import FeatureConfig, extract_features
from .graph import CompGraph, topological_order

__all__ = ["layer_graph", "plan_stages", "PlacementPlan"]

_BYTES = {"bfloat16": 2, "float32": 4}


def layer_graph(cfg: ModelConfig, seq_len: int, batch: int,
                kind: str = "train") -> CompGraph:
    """Layer-granularity computation graph with analytic flops/bytes.

    kind: "train" (fwd+bwd ≈ 3× fwd flops), "prefill", "decode" (T=batch
    tokens against a seq_len-deep context).
    """
    g = CompGraph(f"{cfg.name}/{kind}")
    dt = _BYTES.get(cfg.dtype, 2)
    tokens = batch * (1 if kind == "decode" else seq_len)
    ctx = seq_len
    mult = 3.0 if kind == "train" else 1.0
    d = cfg.d_model

    act_bytes = tokens * d * dt
    g.add_op("embed", "Embed", [], (batch, seq_len, d),
             flops=0.0, bytes_out=act_bytes)
    prev = "embed"
    li = 0
    for rep in range(cfg.pattern_repeats):
        for mixer, ffn in cfg.block_pattern:
            name = f"L{li}_{mixer}"
            if mixer == "attn":
                h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
                proj = 2.0 * tokens * d * (h + kv * 2) * hd + \
                    2.0 * tokens * h * hd * d
                window = min(ctx, cfg.sliding_window) if cfg.sliding_window \
                    else ctx
                attn = 4.0 * tokens * window * h * hd
                flops = (proj + attn) * mult
            else:
                di, st, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
                proj = 2.0 * tokens * d * (2 * di + 2 * st + nh) + \
                    2.0 * tokens * di * d
                scan = 10.0 * tokens * nh * cfg.ssm_head_dim * st
                flops = (proj + scan) * mult
            g.add_op(name, "Attention" if mixer == "attn" else "SSM",
                     [prev], (batch, seq_len, d), flops=flops,
                     bytes_out=act_bytes)
            prev = name
            if ffn != "none":
                fname = f"L{li}_{ffn}"
                fe = cfg.moe_d_ff or cfg.d_ff
                nmat = 3 if cfg.activation == "swiglu" else 2
                if ffn == "moe":
                    flops = (2.0 * tokens * cfg.moe_top_k * nmat * d * fe +
                             2.0 * tokens * d * cfg.moe_experts) * mult
                else:
                    flops = 2.0 * tokens * nmat * d * cfg.d_ff * mult
                g.add_op(fname, "MoE" if ffn == "moe" else "FFN",
                         [prev], (batch, seq_len, d), flops=flops,
                         bytes_out=act_bytes)
                prev = fname
            li += 1
    g.add_op("unembed", "Unembed", [prev], (batch, seq_len, cfg.vocab_size),
             flops=2.0 * tokens * d * cfg.vocab_size * mult,
             bytes_out=tokens * cfg.vocab_size * dt)
    return g


@dataclasses.dataclass
class PlacementPlan:
    stage_of_node: np.ndarray       # per layer-graph node
    boundaries: List[int]           # layer indices where stages switch
    latency: float                  # cost-model makespan of the plan
    baseline_latency: float         # even-split baseline makespan
    graph: CompGraph


def _monotone_projection(placement: np.ndarray, order: np.ndarray,
                         num_stages: int) -> np.ndarray:
    """Project an arbitrary placement to a non-decreasing stage assignment
    along the topological order (pipeline contiguity constraint)."""
    proj = placement.copy()
    cur = 0
    for v in order:
        s = int(np.clip(proj[v], cur, num_stages - 1))
        proj[v] = s
        cur = s
    return proj


def plan_stages(cfg: ModelConfig, *, seq_len: int, batch: int,
                num_stages: int = 2, kind: str = "train",
                hsdag_cfg=None, seed: int = 0,
                device="cuda") -> PlacementPlan:
    """HSDAG search for a pipeline-stage assignment of ``cfg``'s layers."""
    from .hsdag import HSDAG, HSDAGConfig

    g = layer_graph(cfg, seq_len, batch, kind)
    platform = tpu_stage_platform(num_stages=num_stages)
    arrays = extract_features(g, FeatureConfig(d_pos=16))
    order = topological_order(g)

    def reward_fn(placement):
        mono = _monotone_projection(placement, order, num_stages)
        res = simulate(g, mono, platform, order=order)
        return res.reward, res.latency

    agent = HSDAG(hsdag_cfg or HSDAGConfig(
        num_devices=num_stages, max_episodes=20, update_timestep=10,
        hidden_channel=64, seed=seed), device=device)
    result = agent.search(g, arrays, reward_fn=reward_fn)
    best = _monotone_projection(result.best_placement, order, num_stages)

    # even-split baseline for comparison
    even = np.minimum((np.arange(g.num_nodes) * num_stages) // g.num_nodes,
                      num_stages - 1)
    even = _monotone_projection(even, order, num_stages)
    base = simulate(g, even, platform, order=order).latency

    boundaries = [int(i) for i in range(1, g.num_nodes)
                  if best[order[i]] != best[order[i - 1]]]
    return PlacementPlan(best, boundaries,
                         simulate(g, best, platform, order=order).latency,
                         base, g)
