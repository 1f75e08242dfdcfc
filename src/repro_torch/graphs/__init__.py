"""Benchmark computation graphs (paper §3.1), seedable synthetic DAG
families and the workload-corpus subsystem (provider registry, corpus specs,
streaming corpora)."""
from .inception import inception_v3
from .resnet import resnet50
from .bert import bert_base
from .synthetic import (DEFAULT_OP_MIX, SYNTHETIC_FAMILIES, branch_join_dag,
                        layered_dag, series_parallel_dag)
from .workloads import (CorpusSpec, GraphMeta, StreamingCorpus,
                        WorkloadProvider, build_corpus, corpus_fingerprint,
                        get_workload, parse_corpus_spec, register_workload,
                        workload_names)

PAPER_BENCHMARKS = {
    "inception_v3": inception_v3,
    "resnet50": resnet50,
    "bert_base": bert_base,
}

__all__ = ["inception_v3", "resnet50", "bert_base", "PAPER_BENCHMARKS",
           "layered_dag", "series_parallel_dag", "branch_join_dag",
           "SYNTHETIC_FAMILIES", "DEFAULT_OP_MIX",
           "WorkloadProvider", "register_workload", "get_workload",
           "workload_names", "CorpusSpec", "parse_corpus_spec",
           "build_corpus", "corpus_fingerprint", "GraphMeta",
           "StreamingCorpus"]
