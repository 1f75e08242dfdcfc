"""Weights carried across from the reference package's checkpoints."""
from .convert import (lm_params_from_numpy, load_reference_policy,
                      params_from_numpy, params_to_numpy, tree_from_tensors)

__all__ = ["lm_params_from_numpy", "load_reference_policy",
           "params_from_numpy", "params_to_numpy", "tree_from_tensors"]
