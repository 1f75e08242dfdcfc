"""ResNet-50 computation graph (paper benchmark #2, Table 1: |V|=396)."""
from __future__ import annotations

from ..core.graph import CompGraph
from .builder import IRBuilder


def resnet50(include_consts: bool = True) -> CompGraph:
    b = IRBuilder("resnet50", include_consts=include_consts)
    x = b.input((1, 3, 224, 224))
    # Stem
    x = b.conv2d(x, 3, 64, 7, 224, 224, stride=2)
    h = w = 112
    x = b.pool(x, 64, h, w, k=3, stride=2)
    h = w = 56

    stages = [  # (blocks, c_in, c_mid, c_out, stride of first block)
        (3, 64, 64, 256, 1),
        (4, 256, 128, 512, 2),
        (6, 512, 256, 1024, 2),
        (3, 1024, 512, 2048, 2),
    ]
    for blocks, cin, cmid, cout, stride0 in stages:
        for i in range(blocks):
            stride = stride0 if i == 0 else 1
            ci = cin if i == 0 else cout
            identity = x
            y = b.conv2d(x, ci, cmid, 1, h, w, stride=stride)
            nh, nw = h // stride, w // stride
            y = b.conv2d(y, cmid, cmid, 3, nh, nw)
            y = b.conv2d(y, cmid, cout, 1, nh, nw, relu=False)
            if i == 0:
                identity = b.conv2d(identity, ci, cout, 1, h, w,
                                    stride=stride, relu=False)
            h, w = nh, nw
            y = b.eltwise("Add", [y, identity], (1, cout, h, w))
            x = b.op("ReLU", [y], (1, cout, h, w), flops=float(cout * h * w))
    x = b.pool(x, 2048, h, w, k=h, stride=h, kind="AvgPool")
    x = b.op("Reshape", [x], (1, 2048))
    x = b.matmul(x, 1, 2048, 1000)
    b.softmax(x, (1, 1000))
    g = b.g
    g.validate_acyclic()
    return g
