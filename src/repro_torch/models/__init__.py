"""LM substrate: configs, layers, SSD mixer, decoder assembly (serving).

Port of ``repro/models`` for serving every architecture of the reference's
registry; the train step and int8 serving wait for a later slice."""
from .config import ModelConfig
from .layers import AttnCache
from .lm import (decode_step, forward, init_cache, init_params,
                 make_serve_step, model_defs, prefill)
from .ssm import SSMCache

__all__ = [
    "ModelConfig", "model_defs", "init_params", "forward", "prefill",
    "decode_step", "init_cache", "make_serve_step", "AttnCache", "SSMCache",
]
