"""Distribution substrate: sharding rules, pipeline, compression, elastic."""
from .sharding import (AxisRules, DEFAULT_RULES, ROLLOUT_RULES, logical_spec,
                       param_specs, shard, use_rules, with_rules)
from .compression import (compressed_allreduce_tree, compressed_psum_mean,
                          dequantize_int8, quantize_int8)
from .elastic import (ElasticController, PreemptionFlusher,
                      StragglerWatchdog, choose_mesh_shape)
from .pipeline import make_pipeline_fn, pipeline_apply

__all__ = [
    "AxisRules", "DEFAULT_RULES", "ROLLOUT_RULES", "logical_spec",
    "param_specs", "shard", "use_rules", "with_rules",
    "compressed_allreduce_tree", "compressed_psum_mean",
    "dequantize_int8", "quantize_int8",
    "ElasticController", "PreemptionFlusher", "StragglerWatchdog",
    "choose_mesh_shape",
    "make_pipeline_fn", "pipeline_apply",
]
