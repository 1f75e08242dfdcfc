"""The reference's traced transformer-layer graph, built in numpy.

The reference's ``traced`` workload provider traces one fixed function, an
attention + GELU-FFN layer written in ``jax.numpy``
(``repro/graphs/workloads.py``'s ``TracedLayerWorkloads._trace_layer``),
with its ``trace_to_graph``: a ``Parameter`` node ``param_i`` per argument,
then one node per jaxpr equation named ``{primitive}_{i}``, with the
equation's output shape, its FLOP estimate (``_eqn_flops``) and its float32
output bytes, an edge from the producer of every non-literal input.

A torch trace gives aten ops, not jaxpr primitives, so this module writes
the layer's jaxpr down instead: the same 33 equations in the same order
for any ``(seq, d, heads, head_dim, d_ff)``, with the literals (the softmax
scale, ``-inf``, the GELU constants) dropped from the inputs as the tracer
drops them.  ``tests/test_torch_workloads.py`` holds it bitwise against the
reference's trace, so a JAX release that traces the layer to another jaxpr
fails there.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.graph import CompGraph

__all__ = ["traced_layer_graph"]

_F32 = 4
#: primitives ``_eqn_flops`` prices at 8 FLOPs an output element
_TRANSCENDENTAL = ("exp", "tanh")
#: primitives it prices at one FLOP an input element
_REDUCTIONS = ("reduce_sum", "reduce_max")


def _elems(shape: Sequence[int]) -> float:
    return float(np.prod(shape)) if len(shape) else 1.0


def traced_layer_graph(seq: int, d: int, heads: int, head_dim: int,
                       d_ff: int, name: str = "traced") -> CompGraph:
    """The graph ``trace_to_graph`` gives for the reference's layer at these
    sizes (``heads`` is ``max(1, n_heads)`` of the config)."""
    seq, d, h, hd, f = (int(v) for v in (seq, d, heads, head_dim, d_ff))
    hh = h * hd
    g = CompGraph(name)
    shapes: Dict[str, Tuple[int, ...]] = {}
    params = [(seq, d), (d, hh), (d, hh), (d, hh), (hh, d), (d, f), (f, d)]
    for i, shape in enumerate(params):
        nm = f"param_{i}"
        g.add_op(nm, "Parameter", [], shape, flops=0.0,
                 bytes_out=_elems(shape) * _F32)
        shapes[nm] = shape
    eqns: List[str] = []

    def eqn(prim: str, ins: Sequence[str], shape: Tuple[int, ...],
            contract: float = 1.0) -> str:
        nm = f"{prim}_{len(eqns)}"
        out = _elems(shape)
        if prim == "dot_general":
            flops = 2.0 * out * contract
        elif prim in _TRANSCENDENTAL:
            flops = 8.0 * out
        elif prim in _REDUCTIONS:
            flops = _elems(shapes[ins[0]])
        else:
            flops = out
        g.add_op(nm, prim, list(ins), shape, flops=flops,
                 bytes_out=out * _F32)
        shapes[nm] = shape
        eqns.append(nm)
        return nm

    x, wq, wk, wv, wo, w1, w2 = (f"param_{i}" for i in range(7))
    # q, k, v = (x @ w).reshape(seq, h, hd)
    qkv = []
    for w in (wq, wk, wv):
        p = eqn("dot_general", [x, w], (seq, hh), contract=d)
        qkv.append(eqn("reshape", [p], (seq, h, hd)))
    q, k, v = qkv
    # s = einsum("qhd,khd->hqk", q, k) / sqrt(hd)
    s = eqn("dot_general", [q, k], (h, seq, seq), contract=hd)
    s = eqn("div", [s], (h, seq, seq))
    # softmax over the last axis
    m = eqn("reduce_max", [s], (h, seq))
    m = eqn("max", [m], (h, seq))
    m = eqn("broadcast_in_dim", [m], (h, seq, 1))
    m = eqn("stop_gradient", [m], (h, seq, 1))
    e = eqn("sub", [s, m], (h, seq, seq))
    e = eqn("exp", [e], (h, seq, seq))
    z = eqn("reduce_sum", [e], (h, seq))
    z = eqn("broadcast_in_dim", [z], (h, seq, 1))
    a = eqn("div", [e, z], (h, seq, seq))
    # o = einsum("hqk,khd->qhd", a, v).reshape(seq, h * hd)
    o = eqn("dot_general", [v, a], (h, hd, seq), contract=seq)
    o = eqn("transpose", [o], (seq, h, hd))
    o = eqn("reshape", [o], (seq, hh))
    o = eqn("dot_general", [o, wo], (seq, d), contract=hh)
    x1 = eqn("add", [x, o], (seq, d))
    # hidden = gelu(x1 @ w1), the tanh approximation
    u = eqn("dot_general", [x1, w1], (seq, f), contract=d)
    c = eqn("integer_pow", [u], (seq, f))
    c = eqn("mul", [c], (seq, f))
    c = eqn("add", [u, c], (seq, f))
    c = eqn("mul", [c], (seq, f))
    c = eqn("tanh", [c], (seq, f))
    c = eqn("add", [c], (seq, f))
    c = eqn("mul", [c], (seq, f))
    hid = eqn("mul", [u, c], (seq, f))
    y = eqn("dot_general", [hid, w2], (seq, d), contract=f)
    eqn("add", [x1, y], (seq, d))
    g.validate_acyclic()
    return g
