"""Shared helpers for building OpenVINO-IR-style computation graphs.

The paper's graphs (Table 1) come from OpenVINO's Model Optimizer: already
coarsened (BN folded into conv), but still carrying weight Const (+ fp16→fp32
Convert) nodes — which is what pushes |V| to 396–1009 at an average degree of
~1.05 (many in-degree-0 const leaves).  These helpers reproduce that style so
graph statistics, feature distributions and placement dynamics match the
paper's setting.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..core.graph import CompGraph

DTYPE_BYTES = 4  # f32 activations


class IRBuilder:
    """Thin stateful wrapper over CompGraph with OpenVINO-ish op helpers."""

    def __init__(self, name: str, include_consts: bool = True,
                 include_converts: bool = True):
        self.g = CompGraph(name)
        self.include_consts = include_consts
        self.include_converts = include_converts
        self._uid = 0

    def _fresh(self, prefix: str) -> str:
        self._uid += 1
        return f"{prefix}_{self._uid}"

    # ------------------------------------------------------------ leaf nodes
    def const(self, shape: Tuple[int, ...], name: Optional[str] = None) -> str:
        """Weight constant (+ optional Convert), as in OpenVINO IR."""
        cname = name or self._fresh("const")
        elems = 1
        for s in shape:
            elems *= s
        self.g.add_op(cname, "Const", [], shape, flops=0,
                      bytes_out=elems * DTYPE_BYTES)
        if self.include_converts:
            vname = cname + "/cvt"
            self.g.add_op(vname, "Convert", [cname], shape,
                          flops=elems, bytes_out=elems * DTYPE_BYTES)
            return vname
        return cname

    def input(self, shape: Tuple[int, ...], name: str = "input") -> str:
        elems = 1
        for s in shape:
            elems *= s
        self.g.add_op(name, "Parameter", [], shape, flops=0,
                      bytes_out=elems * DTYPE_BYTES)
        return name

    # -------------------------------------------------------------- compute
    def _elems(self, shape: Sequence[int]) -> int:
        n = 1
        for s in shape:
            n *= s
        return n

    def op(self, op_type: str, inputs: Sequence[str],
           out_shape: Tuple[int, ...], flops: float = 0.0,
           name: Optional[str] = None, meta: Optional[dict] = None) -> str:
        nm = name or self._fresh(op_type.lower())
        self.g.add_op(nm, op_type, inputs, out_shape, flops=flops,
                      bytes_out=self._elems(out_shape) * DTYPE_BYTES,
                      meta=meta)
        return nm

    def conv2d(self, x: str, cin: int, cout: int, k: int, h: int, w: int,
               stride: int = 1, relu: bool = True, kw: Optional[int] = None,
               name: Optional[str] = None) -> str:
        """Convolution with folded bias (BN folded, OpenVINO-style).

        ``kw`` supports factorized kernels (1×7 / 7×1): pass k=7, kw=1.
        """
        kh = k
        kw = kw if kw is not None else k
        oh, ow = h // stride, w // stride
        ins = [x]
        if self.include_consts:
            ins.append(self.const((cout, cin, kh, kw)))
            ins.append(self.const((cout,)))
        flops = 2.0 * cout * cin * kh * kw * oh * ow
        # Per-kernel-family achieved-efficiency hints (measured-cost-model
        # style lookup; see costmodel.py docstring): OpenVINO's CPU plugin
        # shines on factorized/winograd-able kernels, its GPU plugin lacks
        # fast paths for 1×N and 5×5 kernels at batch 1.
        if kh == 1 and kw == 1:
            eff = {"eff_cpu": 0.50, "eff_gpu": 0.33}
        elif min(kh, kw) == 1:                      # factorized 1×N / N×1
            eff = {"eff_cpu": 0.85, "eff_gpu": 0.05}
        elif max(kh, kw) >= 5:                      # 5×5 / 7×7
            eff = {"eff_cpu": 0.60, "eff_gpu": 0.12}
        else:                                       # 3×3 (winograd on CPU)
            eff = {"eff_cpu": 0.55, "eff_gpu": 0.30}
        out = self.op("Convolution", ins, (1, cout, oh, ow), flops, name,
                      meta=eff)
        if relu:
            out = self.op("ReLU", [out], (1, cout, oh, ow),
                          flops=self._elems((cout, oh, ow)))
        return out

    def pool(self, x: str, c: int, h: int, w: int, k: int, stride: int,
             kind: str = "MaxPool") -> str:
        oh, ow = h // stride, w // stride
        return self.op(kind, [x], (1, c, oh, ow),
                       flops=float(c * oh * ow * k * k))

    def matmul(self, x: str, rows: int, cin: int, cout: int,
               bias: bool = True, name: Optional[str] = None) -> str:
        ins = [x]
        if self.include_consts:
            ins.append(self.const((cin, cout)))
        out = self.op("MatMul", ins, (1, rows, cout),
                      2.0 * rows * cin * cout, name)
        if bias:
            ins_b = [out]
            if self.include_consts:
                ins_b.append(self.const((cout,)))
            out = self.op("Add", ins_b, (1, rows, cout),
                          flops=float(rows * cout))
        return out

    def eltwise(self, op_type: str, inputs: Sequence[str],
                shape: Tuple[int, ...]) -> str:
        return self.op(op_type, inputs, shape, flops=float(self._elems(shape)))

    def concat(self, inputs: Sequence[str], shape: Tuple[int, ...]) -> str:
        return self.op("Concat", inputs, shape, flops=0.0)

    def softmax(self, x: str, shape: Tuple[int, ...]) -> str:
        return self.op("SoftMax", [x], shape,
                       flops=5.0 * self._elems(shape))

    def layer_norm(self, x: str, rows: int, dim: int) -> str:
        """LayerNorm as the decomposed op chain OpenVINO emits (MVN + affine)."""
        shape = (1, rows, dim)
        mvn = self.op("MVN", [x], shape, flops=8.0 * rows * dim)
        ins_g = [mvn]
        if self.include_consts:
            ins_g.append(self.const((dim,)))
        mul = self.op("Multiply", ins_g, shape, flops=float(rows * dim))
        ins_b = [mul]
        if self.include_consts:
            ins_b.append(self.const((dim,)))
        return self.op("Add", ins_b, shape, flops=float(rows * dim))

    def gelu(self, x: str, rows: int, dim: int) -> str:
        return self.op("Gelu", [x], (1, rows, dim), flops=8.0 * rows * dim)
