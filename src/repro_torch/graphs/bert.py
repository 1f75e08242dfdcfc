"""BERT-base (uncased) computation graph (paper benchmark #3, Table 1: |V|=1009).

Decomposed the way OpenVINO's Model Optimizer emits transformer encoders:
per-head attention kept as fused batched MatMuls, LayerNorm as MVN + affine,
weights as Const(+Convert) leaves.  Seq len 128, batch 1 (paper-style
inference).  Big dense MatMuls make this the most GPU-friendly benchmark
(Table 2: 56.5% GPU-only speedup; HSDAG 58.2%).
"""
from __future__ import annotations

from ..core.graph import CompGraph
from .builder import IRBuilder

D = 768
HEADS = 12
DFF = 3072


def bert_base(seq_len: int = 32, layers: int = 12,
              include_consts: bool = True) -> CompGraph:
    # seq_len=32 reproduces the paper's measured latency regime (Table 2's
    # 6.38 ms CPU / 2.77 ms GPU imply a short-sequence BERT; |V|/|E| stats are
    # independent of seq_len).
    b = IRBuilder("bert_base", include_consts=include_consts)
    s = seq_len
    ids = b.input((1, s), name="input_ids")
    type_ids = b.input((1, s), name="token_type_ids")
    mask = b.input((1, s), name="attention_mask")

    # Embeddings: three gathers + add + LN
    we = b.const((30522, D), "word_emb")
    pe = b.const((512, D), "pos_emb")
    te = b.const((2, D), "type_emb")
    gw = b.op("Gather", [ids, we], (1, s, D), flops=0.0)
    gp = b.op("Gather", [pe], (1, s, D), flops=0.0)
    gt = b.op("Gather", [type_ids, te], (1, s, D), flops=0.0)
    x = b.eltwise("Add", [gw, gp], (1, s, D))
    x = b.eltwise("Add", [x, gt], (1, s, D))
    x = b.layer_norm(x, s, D)

    # Attention mask preprocessing
    m = b.op("Unsqueeze", [mask], (1, 1, 1, s))
    m = b.eltwise("Multiply", [m], (1, 1, 1, s))
    m = b.eltwise("Add", [m], (1, 1, 1, s))

    dh = D // HEADS
    for _ in range(layers):
        resid = x
        q = b.matmul(x, s, D, D)
        k = b.matmul(x, s, D, D)
        v = b.matmul(x, s, D, D)
        qt = b.op("Reshape", [q], (1, HEADS, s, dh))
        kt = b.op("Reshape", [k], (1, HEADS, s, dh))
        vt = b.op("Reshape", [v], (1, HEADS, s, dh))
        scores = b.op("MatMul", [qt, kt], (1, HEADS, s, s),
                      flops=2.0 * HEADS * s * s * dh)
        scores = b.eltwise("Multiply", [scores], (1, HEADS, s, s))
        scores = b.eltwise("Add", [scores, m], (1, HEADS, s, s))
        probs = b.softmax(scores, (1, HEADS, s, s))
        ctx = b.op("MatMul", [probs, vt], (1, HEADS, s, dh),
                   flops=2.0 * HEADS * s * s * dh)
        ctx = b.op("Reshape", [ctx], (1, s, D))
        attn = b.matmul(ctx, s, D, D)
        x = b.eltwise("Add", [attn, resid], (1, s, D))
        x = b.layer_norm(x, s, D)
        resid2 = x
        ff = b.matmul(x, s, D, DFF)
        ff = b.gelu(ff, s, DFF)
        ff = b.matmul(ff, s, DFF, D)
        x = b.eltwise("Add", [ff, resid2], (1, s, D))
        x = b.layer_norm(x, s, D)

    # Pooler
    first = b.op("Gather", [x], (1, D))
    pooled = b.matmul(first, 1, D, D)
    b.op("Tanh", [pooled], (1, D), flops=float(D))
    g = b.g
    g.validate_acyclic()
    return g
