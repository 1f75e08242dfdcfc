"""Checkpoints in the reference's format, and weights carried across from
the reference package."""
from .convert import (lm_params_from_numpy, lm_train_state_from_numpy,
                      load_reference_policy, params_from_numpy,
                      params_to_numpy, tree_from_tensors)
from .manager import (CheckpointManager, policy_feature_config,
                      policy_manifest, restore_policy, save_policy)

__all__ = ["CheckpointManager", "lm_params_from_numpy",
           "lm_train_state_from_numpy",
           "load_reference_policy", "params_from_numpy", "params_to_numpy",
           "policy_feature_config", "policy_manifest", "restore_policy",
           "save_policy", "tree_from_tensors"]
