"""Device-placement policy head (paper §2.5) — PyTorch.

Port of ``repro/core/policy.py``: each coarsened node (cluster slot) is
placed on one of |D| devices, and the coarse placement maps back to the
original graph through the cluster labels.  Batched over a leading chain
axis B.  Two heads, as ``head=`` of ``HSDAGConfig`` picks:

``dense``   the paper's fixed ``Dense(num_devices)`` output layer.
``device``  slot embeddings meet device embeddings (an MLP over the
            ``(D, DEV_FEATURE_DIM)`` fleet table of
            ``platforms.device_feature_table``) in a scaled dot product, so
            one set of weights scores fleets of any size: |D| is the fleet's.
            An optional per-(node, device) capacity mask
            (``SimArrays.fit_ok``) removes devices a node can never fit; it
            is lifted to cluster slots by a min over their members, with an
            unmasked fallback for a slot no single device can hold.

Sampling draws nothing itself: a categorical sample is
``argmax(logits / T + gumbel)``, and the caller passes the Gumbel noise, so
a test can feed the reference's draws and a replay can pass the actions it
sampled.  ``T`` is the per-chain temperature population search threads in
(none by default).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from . import prng
from .gnn import MLP, mlp_init

__all__ = ["policy_init", "DensePolicy", "DevicePolicy", "policy_apply",
           "PolicyOutput"]

#: Additive logit penalty of a capacity-masked action, applied after the
#: temperature: exp(-1e9) is 0 in float32, and the log-softmax stays finite.
_MASK_PENALTY = -1e9


class PolicyOutput(NamedTuple):
    coarse_placement: torch.Tensor   # (B, V) i64 — device per cluster slot
    fine_placement: torch.Tensor     # (B, V) i64 — device per original node
    logp: torch.Tensor               # (B,) — Σ over active slots of log π
    entropy: torch.Tensor            # (B,) — Σ entropy over active slots
    logits: torch.Tensor             # (B, V, |D|)


def policy_init(key: np.ndarray, hidden: int, num_devices: int, *,
                layers: int = 2, head: str = "dense",
                dev_feat_dim: Optional[int] = None) -> Dict:
    """The reference's ``policy_init`` tree (see ``gnn.mlp_init``)."""
    if head == "dense":
        return {"mlp": mlp_init(key, [hidden] * layers + [num_devices])}
    if head != "device":
        raise ValueError(f"unknown policy head {head!r}; "
                         f"expected 'dense' or 'device'")
    if dev_feat_dim is None:
        raise ValueError("head='device' needs dev_feat_dim "
                         "(the device feature table width)")
    k_node, k_dev = prng.split(key)
    return {"mlp": mlp_init(k_node, [hidden] * layers + [hidden]),
            "dev": mlp_init(k_dev, [dev_feat_dim, hidden, hidden])}


class DensePolicy(nn.Module):
    """The paper's fixed ``Dense(num_devices)`` output head."""

    def __init__(self, hidden: int, num_devices: int, *, layers: int = 2):
        super().__init__()
        self.mlp = MLP([hidden] * layers + [num_devices])

    def forward(self, pooled_z: torch.Tensor, dev_feats=None) -> torch.Tensor:
        return self.mlp(pooled_z)


class DevicePolicy(nn.Module):
    """The slot × device compatibility head: ``mlp`` projects slots to the
    hidden width, ``dev`` embeds the fleet table's rows."""

    def __init__(self, hidden: int, dev_feat_dim: int, *, layers: int = 2):
        super().__init__()
        self.mlp = MLP([hidden] * layers + [hidden])
        self.dev = MLP([dev_feat_dim, hidden, hidden])

    def forward(self, pooled_z: torch.Tensor,
                dev_feats: torch.Tensor) -> torch.Tensor:
        """(B, V, H) slots and a (D, F_dev) fleet table → (B, V, D)."""
        if dev_feats is None:
            raise ValueError("head='device' needs the fleet's device "
                             "feature table (dev_feats)")
        node_proj = self.mlp(pooled_z)
        dev_emb = self.dev(dev_feats)
        # 1 / sqrt(H) in float32, the reference's scale
        scale = np.float32(1.0) / np.sqrt(np.float32(node_proj.shape[-1]))
        return torch.matmul(node_proj, dev_emb.T) * float(scale)


def _cluster_mask(action_mask: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """A per-node (V, D) feasibility mask lifted to the (B, V, D) cluster
    slots: a slot may use the devices every member fits on (a min over its
    members, empty slots keep every device), and a slot no device fits
    falls back to unmasked."""
    B, V = labels.shape
    node_ok = action_mask.to(torch.float32).expand(B, V, -1)
    slot_ok = torch.ones_like(node_ok).scatter_reduce(
        1, labels[..., None].expand_as(node_ok), node_ok, "amin",
        include_self=True)
    ok = slot_ok > 0.5
    return ok | ~ok.any(-1, keepdim=True)


def policy_apply(policy: nn.Module, pooled_z: torch.Tensor,
                 active: torch.Tensor, labels: torch.Tensor, *,
                 greedy: bool = False,
                 gumbel: Optional[torch.Tensor] = None,
                 actions: Optional[torch.Tensor] = None,
                 temperature: Optional[torch.Tensor] = None,
                 dev_feats: Optional[torch.Tensor] = None,
                 action_mask: Optional[torch.Tensor] = None) -> PolicyOutput:
    """Place every active cluster slot and map the slots to nodes.

    Exactly one of ``greedy``, ``gumbel`` (B, V, |D|) noise to sample with,
    or ``actions`` (B, V) coarse placements to score (the Eq.-14 replay,
    the reference's ``placement_logp``) picks the coarse placement.
    ``temperature`` (B,) divides the logits first, so ``logp`` and
    ``entropy`` follow the tempered distribution.  ``dev_feats`` (D, F_dev)
    is the device head's fleet table; ``action_mask`` (V, D) bool, after the
    temperature, adds ``-1e9`` to the logits of the devices a slot's members
    do not all fit on — sampling and replay must pass the same mask.

    The log-probabilities come from ``log_softmax``, which shifts by the
    row's maximum: ``logits - logsumexp(logits)`` would differentiate
    through ``exp(logits - lse)``, whose rounding at the logits' magnitude
    swamps ``1 - p`` of a slot that is nearly certain of its device, and
    with it the slot's gradient.
    """
    logits = policy(pooled_z, dev_feats)
    if temperature is not None:
        logits = logits / temperature[:, None, None]
    if action_mask is not None:
        ok = _cluster_mask(action_mask, labels)
        logits = torch.where(ok, logits, logits + _MASK_PENALTY)
    logp_full = torch.log_softmax(logits, dim=-1)
    if actions is not None:
        coarse = actions
    elif greedy:
        coarse = torch.argmax(logits, dim=-1)
    elif gumbel is not None:
        coarse = torch.argmax(logits + gumbel, dim=-1)
    else:
        raise ValueError("policy_apply needs greedy=True, gumbel noise or "
                         "recorded actions")
    chosen = torch.gather(logp_full, -1, coarse[..., None])[..., 0]
    act = active.to(logits.dtype)
    logp = torch.sum(chosen * act, dim=-1)
    entropy = torch.sum(-torch.sum(torch.exp(logp_full) * logp_full, -1)
                        * act, dim=-1)
    fine = torch.gather(coarse, 1, labels)
    return PolicyOutput(coarse, fine, logp, entropy, logits)
