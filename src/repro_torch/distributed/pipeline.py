"""Pipeline parallelism over a process group (GPipe schedule).

Port of ``repro/distributed/pipeline.py``.  The pipeline is a
differentiable program of ``M + S − 1`` ticks: at every tick each stage
(one rank of ``group``) (1) takes a fresh microbatch (stage 0) or its
neighbour's activation, (2) applies its layer slice, (3) ships the result
one hop down the ring.  The ring shift is an autograd function whose
backward ships the gradient one hop back (the transpose of the reference's
``ppermute``), so ``loss.backward()`` through this function *is* the
backward pipeline; ``remat_stage`` recomputes each stage in the backward
(``torch.utils.checkpoint``), keeping activation memory at O(microbatch).

Stage assignment comes from the planner (``core/planner.py``'s
``plan_stages``): the placement policy decides which layer-graph partition
lands on which stage; this module executes that split.

Every rank runs the same program (as under ``torchrun``) with its own
stage's parameters; the reference's single controller passes all stages'
parameters stacked on a leading axis that ``shard_map`` splits.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

__all__ = ["pipeline_apply", "make_pipeline_fn"]


def _peers(group):
    """(this rank's stage, stage count, global rank of stage s + 1, of
    stage s − 1) in ``group``."""
    size = dist.get_world_size(group)
    stage = dist.get_group_rank(group, dist.get_rank()) \
        if group is not None else dist.get_rank()

    def glob(s):
        return dist.get_global_rank(group, s) if group is not None else s

    return stage, size, glob((stage + 1) % size), glob((stage - 1) % size)


def _exchange(send: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``send`` to global rank ``to`` while receiving a tensor of its
    shape from ``frm``."""
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send.contiguous(), to, group),
        dist.P2POp(dist.irecv, recv, frm, group)])
    for r in reqs:
        r.wait()
    return recv


class _RingShift(torch.autograd.Function):
    """Stage s's activation → stage s + 1 (ring); backward: the gradient
    of what stage s received → stage s − 1."""

    @staticmethod
    def forward(ctx, y, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(y, nxt, prv, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.prv, ctx.nxt, ctx.group), None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank.  Every rank then holds the
    same outputs, so a loss on them is one loss: the backward takes the last
    stage's own gradient and gives the other ranks' copies none."""

    @staticmethod
    def forward(ctx, x, group, src):
        ctx.is_src = dist.get_rank() == src
        out = x.detach().clone() if ctx.is_src else torch.empty_like(x)
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.is_src else torch.zeros_like(grad)), None, None


def pipeline_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
                   *, group=None, remat_stage: bool = True) -> torch.Tensor:
    """Run ``stage_fn`` as a pipeline over the ranks of ``group`` (default:
    the whole world), stage s on the group's rank s.

    stage_fn(stage_params, x) -> y — one stage's compute; every stage runs
      the same program with its own params (its layer slice).
    stage_params: this rank's stage's parameters (the reference's leaves
      with their leading stage axis taken at this stage).
    microbatches: (M, ...) — the same on every rank (only stage 0 reads it).

    Returns (M, ...) outputs of the final stage, on every rank.
    """
    stage, num_stages, nxt, prv = _peers(group)
    m = microbatches.shape[0]
    ticks = m + num_stages - 1
    fn = stage_fn
    if remat_stage:
        fn = partial(checkpoint, stage_fn, use_reentrant=False)

    # stage 0 reads microbatch t for t < M, zeros after
    pad = microbatches.new_zeros((num_stages - 1,) + microbatches.shape[1:])
    feed = torch.cat([microbatches, pad], dim=0)              # (ticks, ...)
    first = torch.tensor(stage == 0, device=microbatches.device)
    act = torch.zeros_like(feed[0])
    outs = []
    for t in range(ticks):
        # where(), not a branch: every stage's received activation stays in
        # its graph, so every stage runs every shift's backward in step.
        x = torch.where(first, feed[t], act)
        y = fn(stage_params, x)
        outs.append(y)
        # ship to the next stage (ring; the last stage's product falls off
        # the end and is collected from ``outs``)
        act = (_RingShift.apply(y, group, nxt, prv) if num_stages > 1
               else y)
    # the final stage's outputs for ticks ≥ S−1 are the pipeline's outputs
    last = torch.stack(outs[num_stages - 1:])
    if num_stages == 1:
        return last
    src = dist.get_global_rank(group, num_stages - 1) \
        if group is not None else num_stages - 1
    return _FromLast.apply(last, group, src)


def make_pipeline_fn(stage_fn: Callable, group=None):
    """Convenience: returns f(stage_params, microbatches) → outputs."""
    return partial(pipeline_apply, stage_fn, group=group)
