"""LM substrate: configs, layers, SSD mixer, decoder assembly (training and
serving).

Port of ``repro/models`` for every architecture and option of the
reference's registry, int8 weight-only serving (``models/quantize.py``)
included."""
from .config import ModelConfig
from .layers import AttnCache
from .lm import (TrainState, abstract_params, cross_entropy, decode_step,
                 forward, init_cache, init_params, make_serve_step,
                 make_train_step, model_defs, param_axes, prefill)
from .quantize import (QTensor, dequant_tree, dequantize,
                       init_quantized_params, quantize_params,
                       quantize_tensor)
from .ssm import SSMCache

__all__ = [
    "ModelConfig", "model_defs", "init_params", "abstract_params",
    "param_axes", "forward", "prefill",
    "decode_step", "init_cache", "make_serve_step", "make_train_step",
    "cross_entropy", "TrainState", "AttnCache", "SSMCache", "QTensor",
    "quantize_tensor", "dequantize", "quantize_params", "dequant_tree",
    "init_quantized_params",
]
