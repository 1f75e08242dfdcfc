"""HSDAG core, PyTorch port: graph IR, features, cost model, model, search."""
from .costmodel import (BatchSimResult, DeviceSpec, Platform, SimArrays,
                        SimResult, paper_platform, sim_arrays, simulate)
from .features import (FeatureConfig, GraphArrays, GraphArraysBatch,
                       batch_graph_arrays, extract_features)
from .graph import CompGraph, OpNode, topological_order
from .hsdag import HSDAG, HSDAGConfig, HSDAGPolicy, SearchResult
from .sim import (LevelBackend, ReferenceBackend, RefSim, RewardPipeline,
                  ScanBackend, ScanSim, backend_names, get_backend)

__all__ = ["BatchSimResult", "DeviceSpec", "Platform", "SimArrays",
           "SimResult", "paper_platform", "sim_arrays", "simulate",
           "FeatureConfig", "GraphArrays", "GraphArraysBatch",
           "batch_graph_arrays", "extract_features", "CompGraph", "OpNode",
           "topological_order", "HSDAG", "HSDAGConfig", "HSDAGPolicy",
           "SearchResult", "LevelBackend", "ScanBackend", "ScanSim",
           "ReferenceBackend", "RefSim", "RewardPipeline", "backend_names",
           "get_backend"]
