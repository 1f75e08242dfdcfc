"""LM substrate: configs, layers, SSD mixer, decoder assembly (training and
serving).

Port of ``repro/models`` for every architecture of the reference's
registry; int8 serving waits for a later slice."""
from .config import ModelConfig
from .layers import AttnCache
from .lm import (TrainState, cross_entropy, decode_step, forward, init_cache,
                 init_params, make_serve_step, make_train_step, model_defs,
                 prefill)
from .ssm import SSMCache

__all__ = [
    "ModelConfig", "model_defs", "init_params", "forward", "prefill",
    "decode_step", "init_cache", "make_serve_step", "make_train_step",
    "cross_entropy", "TrainState", "AttnCache", "SSMCache",
]
