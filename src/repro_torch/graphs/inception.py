"""Inception-V3 computation graph (paper benchmark #1, Table 1: |V|=728).

Multi-branch mixed blocks — the benchmark whose branch parallelism gives
heterogeneous placement the most to exploit (paper §3.1), but whose many small
convolutions make GPU dispatch overhead significant (GPU-only only gains 6.25%
in Table 2).
"""
from __future__ import annotations

from typing import List

from ..core.graph import CompGraph
from .builder import IRBuilder


def _branch_avgpool(b: IRBuilder, x: str, cin: int, cout: int, h: int, w: int) -> str:
    p = b.pool(x, cin, h, w, k=3, stride=1, kind="AvgPool")
    return b.conv2d(p, cin, cout, 1, h, w)


def inception_v3(include_consts: bool = True) -> CompGraph:
    b = IRBuilder("inception_v3", include_consts=include_consts)
    x = b.input((1, 3, 299, 299))
    # Stem
    x = b.conv2d(x, 3, 32, 3, 299, 299, stride=2)
    h = w = 149
    x = b.conv2d(x, 32, 32, 3, h, w); h = w = 147
    x = b.conv2d(x, 32, 64, 3, h, w)
    x = b.pool(x, 64, h, w, k=3, stride=2); h = w = 73
    x = b.conv2d(x, 64, 80, 1, h, w)
    x = b.conv2d(x, 80, 192, 3, h, w); h = w = 71
    x = b.pool(x, 192, h, w, k=3, stride=2); h = w = 35
    cin = 192

    # 3 × Mixed 5 (InceptionA): branches 1x1 / 5x5 / 3x3dbl / pool
    for pool_c in (32, 64, 64):
        b1 = b.conv2d(x, cin, 64, 1, h, w)
        b2 = b.conv2d(x, cin, 48, 1, h, w)
        b2 = b.conv2d(b2, 48, 64, 5, h, w)
        b3 = b.conv2d(x, cin, 64, 1, h, w)
        b3 = b.conv2d(b3, 64, 96, 3, h, w)
        b3 = b.conv2d(b3, 96, 96, 3, h, w)
        b4 = _branch_avgpool(b, x, cin, pool_c, h, w)
        cout = 64 + 64 + 96 + pool_c
        x = b.concat([b1, b2, b3, b4], (1, cout, h, w))
        cin = cout

    # Mixed 6a (reduction): 3x3 stride2 / 3x3dbl stride2 / maxpool
    b1 = b.conv2d(x, cin, 384, 3, h, w, stride=2)
    b2 = b.conv2d(x, cin, 64, 1, h, w)
    b2 = b.conv2d(b2, 64, 96, 3, h, w)
    b2 = b.conv2d(b2, 96, 96, 3, h, w, stride=2)
    b3 = b.pool(x, cin, h, w, k=3, stride=2)
    h = w = 17
    cin = 384 + 96 + cin
    x = b.concat([b1, b2, b3], (1, cin, h, w))

    # 4 × Mixed 6 (InceptionB, factorized 7x1/1x7 — OpenVINO keeps both convs)
    for c7 in (128, 160, 160, 192):
        b1 = b.conv2d(x, cin, 192, 1, h, w)
        b2 = b.conv2d(x, cin, c7, 1, h, w)
        b2 = b.conv2d(b2, c7, c7, 7, h, w, kw=1)       # 1x7
        b2 = b.conv2d(b2, c7, 192, 7, h, w, kw=1)      # 7x1
        b3 = b.conv2d(x, cin, c7, 1, h, w)
        b3 = b.conv2d(b3, c7, c7, 7, h, w, kw=1)
        b3 = b.conv2d(b3, c7, c7, 7, h, w, kw=1)
        b3 = b.conv2d(b3, c7, c7, 7, h, w, kw=1)
        b3 = b.conv2d(b3, c7, 192, 7, h, w, kw=1)
        b4 = _branch_avgpool(b, x, cin, 192, h, w)
        cin = 192 * 4
        x = b.concat([b1, b2, b3, b4], (1, cin, h, w))

    # Mixed 7a (reduction)
    b1 = b.conv2d(x, cin, 192, 1, h, w)
    b1 = b.conv2d(b1, 192, 320, 3, h, w, stride=2)
    b2 = b.conv2d(x, cin, 192, 1, h, w)
    b2 = b.conv2d(b2, 192, 192, 7, h, w, kw=1)
    b2 = b.conv2d(b2, 192, 192, 7, h, w, kw=1)
    b2 = b.conv2d(b2, 192, 192, 3, h, w, stride=2)
    b3 = b.pool(x, cin, h, w, k=3, stride=2)
    h = w = 8
    cin = 320 + 192 + cin
    x = b.concat([b1, b2, b3], (1, cin, h, w))

    # 2 × Mixed 7 (InceptionC with split branches)
    for _ in range(2):
        b1 = b.conv2d(x, cin, 320, 1, h, w)
        b2 = b.conv2d(x, cin, 384, 1, h, w)
        b2a = b.conv2d(b2, 384, 384, 3, h, w, kw=1)    # 1x3
        b2b = b.conv2d(b2, 384, 384, 3, h, w, kw=1)    # 3x1
        b2c = b.concat([b2a, b2b], (1, 768, h, w))
        b3 = b.conv2d(x, cin, 448, 1, h, w)
        b3 = b.conv2d(b3, 448, 384, 3, h, w)
        b3a = b.conv2d(b3, 384, 384, 3, h, w, kw=1)
        b3b = b.conv2d(b3, 384, 384, 3, h, w, kw=1)
        b3c = b.concat([b3a, b3b], (1, 768, h, w))
        b4 = _branch_avgpool(b, x, cin, 192, h, w)
        cin = 320 + 768 + 768 + 192
        x = b.concat([b1, b2c, b3c, b4], (1, cin, h, w))

    x = b.pool(x, cin, h, w, k=h, stride=h, kind="AvgPool")
    x = b.op("Reshape", [x], (1, cin))
    x = b.matmul(x, 1, cin, 1000)
    b.softmax(x, (1, 1000))
    g = b.g
    g.validate_acyclic()
    return g
