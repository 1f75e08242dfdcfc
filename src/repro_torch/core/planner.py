"""Layer-granularity LM computation graphs.

Port of ``repro/core/planner.py::layer_graph``: the graph of an
architecture's layers (embed, one node per mixer and FFN, unembed) with
flops and bytes derived analytically from its :class:`ModelConfig` and input
shape.  The corpus's ``lm`` workload provider places these graphs.  The
port's ``ModelConfig`` carries no MoE fields, so a pattern with an ``"moe"``
FFN raises; the stage planner (``plan_stages``) and its TPU-stage platform
wait with the pipeline slice (ROADMAP.md 'Modules to port' item 10).
"""
from __future__ import annotations

from ..models.config import ModelConfig
from .graph import CompGraph

__all__ = ["layer_graph"]

_BYTES = {"bfloat16": 2, "float32": 4}


def layer_graph(cfg: ModelConfig, seq_len: int, batch: int,
                kind: str = "train") -> CompGraph:
    """Layer-granularity computation graph with analytic flops/bytes.

    kind: "train" (fwd+bwd ≈ 3× fwd flops), "prefill", "decode" (T=batch
    tokens against a seq_len-deep context).
    """
    if any(ffn == "moe" for _, ffn in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: MoE layer graphs need the MoE fields of "
            f"ModelConfig, which wait with the MoE archs (ROADMAP.md "
            f"'Modules to port' item 11)")
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
                nmat = 3 if cfg.activation == "swiglu" else 2
                flops = 2.0 * tokens * nmat * d * cfg.d_ff * mult
                g.add_op(fname, "FFN", [prev], (batch, seq_len, d),
                         flops=flops, bytes_out=act_bytes)
                prev = fname
            li += 1
    g.add_op("unembed", "Unembed", [prev], (batch, seq_len, cfg.vocab_size),
             flops=2.0 * tokens * d * cfg.vocab_size * mult,
             bytes_out=tokens * cfg.vocab_size * dt)
    return g
