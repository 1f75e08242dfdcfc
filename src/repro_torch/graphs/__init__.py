"""Benchmark computation graphs (paper §3.1) and seedable synthetic DAG
families."""
from .inception import inception_v3
from .resnet import resnet50
from .bert import bert_base
from .synthetic import (DEFAULT_OP_MIX, SYNTHETIC_FAMILIES, branch_join_dag,
                        layered_dag, series_parallel_dag)

PAPER_BENCHMARKS = {
    "inception_v3": inception_v3,
    "resnet50": resnet50,
    "bert_base": bert_base,
}

__all__ = ["inception_v3", "resnet50", "bert_base", "PAPER_BENCHMARKS",
           "layered_dag", "series_parallel_dag", "branch_join_dag",
           "SYNTHETIC_FAMILIES", "DEFAULT_OP_MIX"]
