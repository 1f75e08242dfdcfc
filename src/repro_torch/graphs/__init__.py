"""Benchmark computation graphs (paper §3.1)."""
from .inception import inception_v3
from .resnet import resnet50
from .bert import bert_base

PAPER_BENCHMARKS = {
    "inception_v3": inception_v3,
    "resnet50": resnet50,
    "bert_base": bert_base,
}

__all__ = ["inception_v3", "resnet50", "bert_base", "PAPER_BENCHMARKS"]
