"""HSDAG core, PyTorch port: graph IR, features, cost model, model, search."""
from .costmodel import (BatchSimResult, DeviceSpec, Platform, SimArrays,
                        SimArraysBatch, SimResult, critical_path,
                        pad_sim_arrays, paper_platform, plan_buckets,
                        sim_arrays, sim_arrays_batch, sim_arrays_bucketed,
                        simulate, tpu_stage_platform)
from .features import (FeatureConfig, GraphArrays, GraphArraysBatch,
                       batch_graph_arrays, batch_graph_arrays_bucketed,
                       check_feature_compat, extract_features,
                       shared_feature_config)
from .graph import CompGraph, OpNode, topological_order
from .hsdag import (HSDAG, HSDAGConfig, HSDAGPolicy, MultiGraphTrainer,
                    MultiSearchResult, SearchResult)
from .sim import (LevelBackend, ReferenceBackend, RefSim, RewardPipeline,
                  ScanBackend, ScanSim, backend_names, get_backend)
from .train.curriculum import CorpusTrainResult, CurriculumTrainer
from .train.population import (ChainState, PopulationConfig,
                               PopulationController)
from .train.sampler import CurriculumSampler

__all__ = ["BatchSimResult", "DeviceSpec", "Platform", "SimArrays",
           "SimArraysBatch", "SimResult", "critical_path", "pad_sim_arrays",
           "paper_platform", "plan_buckets", "sim_arrays", "sim_arrays_batch",
           "sim_arrays_bucketed", "simulate", "tpu_stage_platform",
           "FeatureConfig", "GraphArrays", "GraphArraysBatch",
           "batch_graph_arrays", "batch_graph_arrays_bucketed",
           "check_feature_compat", "extract_features",
           "shared_feature_config", "CompGraph", "OpNode",
           "topological_order", "HSDAG", "HSDAGConfig", "HSDAGPolicy",
           "MultiGraphTrainer", "MultiSearchResult", "SearchResult",
           "LevelBackend", "ScanBackend", "ScanSim",
           "ReferenceBackend", "RefSim", "RewardPipeline", "backend_names",
           "get_backend", "CurriculumTrainer", "CorpusTrainResult",
           "CurriculumSampler", "PopulationConfig", "PopulationController",
           "ChainState"]
