"""Device-placement policy head (paper §2.5) — PyTorch, dense head.

Port of ``repro/core/policy.py`` for ``head="dense"``: an MLP classifies each
coarsened node (cluster slot) to one of |D| devices, and the coarse placement
maps back to the original graph through the cluster labels.  Batched over a
leading chain axis B.

Sampling draws nothing itself: a categorical sample is
``argmax(logits / T + gumbel)``, and the caller passes the Gumbel noise, so
a test can feed the reference's draws and a replay can pass the actions it
sampled.  ``T`` is the per-chain temperature population search threads in
(none by default).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from .gnn import MLP

__all__ = ["DensePolicy", "policy_apply", "PolicyOutput"]


class PolicyOutput(NamedTuple):
    coarse_placement: torch.Tensor   # (B, V) i64 — device per cluster slot
    fine_placement: torch.Tensor     # (B, V) i64 — device per original node
    logp: torch.Tensor               # (B,) — Σ over active slots of log π
    entropy: torch.Tensor            # (B,) — Σ entropy over active slots
    logits: torch.Tensor             # (B, V, |D|)


class DensePolicy(nn.Module):
    """The paper's fixed ``Dense(num_devices)`` output head."""

    def __init__(self, hidden: int, num_devices: int, *, layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = MLP([hidden] * layers + [num_devices], generator)


def policy_apply(policy: DensePolicy, pooled_z: torch.Tensor,
                 active: torch.Tensor, labels: torch.Tensor, *,
                 greedy: bool = False,
                 gumbel: Optional[torch.Tensor] = None,
                 actions: Optional[torch.Tensor] = None,
                 temperature: Optional[torch.Tensor] = None) -> PolicyOutput:
    """Place every active cluster slot and map the slots to nodes.

    Exactly one of ``greedy``, ``gumbel`` (B, V, |D|) noise to sample with,
    or ``actions`` (B, V) coarse placements to score (the Eq.-14 replay)
    picks the coarse placement.  ``temperature`` (B,) divides the logits
    first, so ``logp`` and ``entropy`` follow the tempered distribution.

    The log-probabilities come from ``log_softmax``, which shifts by the
    row's maximum: ``logits - logsumexp(logits)`` would differentiate
    through ``exp(logits - lse)``, whose rounding at the logits' magnitude
    swamps ``1 - p`` of a slot that is nearly certain of its device, and
    with it the slot's gradient.
    """
    logits = policy.mlp(pooled_z)
    if temperature is not None:
        logits = logits / temperature[:, None, None]
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
