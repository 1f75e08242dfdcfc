"""Elastic scaling, straggler mitigation, and preemption handling.

Port of ``repro/distributed/elastic.py``.  The failure model is: slow hosts
(stragglers), dead hosts (shrink + restart from checkpoint), and
preemptions (flush + exit).  These pieces are host-level control logic:

  * ``StragglerWatchdog`` — per-step wall-time EMA + outlier detection;
    a hook to report the slow host for exclusion at the next re-mesh.
  * ``ElasticController`` — decides the mesh for the ranks that are alive,
    and restores a checkpoint onto it (arrays are stored unsharded by
    ``checkpoint/manager.py``, so a restore may re-shard them).
  * ``PreemptionFlusher`` — SIGTERM-driven final checkpoint.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import TYPE_CHECKING, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

if TYPE_CHECKING:  # checkpoint imports core, which imports this package
    from ..checkpoint import CheckpointManager

__all__ = ["StragglerWatchdog", "ElasticController", "PreemptionFlusher",
           "choose_mesh_shape"]


class StragglerWatchdog:
    """Flags steps (hosts) whose wall time exceeds ``threshold`` × EMA."""

    def __init__(self, threshold: float = 2.0, beta: float = 0.9,
                 warmup_steps: int = 5):
        self.threshold = threshold
        self.beta = beta
        self.warmup = warmup_steps
        self.ema: Optional[float] = None
        self.count = 0
        self.flagged: List[Tuple[int, float]] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self.count += 1
        if self.ema is None:
            self.ema = seconds
            return False
        is_slow = (self.count > self.warmup and
                   seconds > self.threshold * self.ema)
        if is_slow:
            self.flagged.append((step, seconds))
        else:
            # stragglers don't poison the baseline
            self.ema = self.beta * self.ema + (1 - self.beta) * seconds
        return is_slow


def choose_mesh_shape(num_devices: int,
                      model_parallel: int) -> Tuple[int, int]:
    """(data, model) for the available device count — shrink data-parallel
    first (model sharding is dictated by memory, not throughput)."""
    model = model_parallel
    while model > 1 and num_devices % model:
        model //= 2
    return max(1, num_devices // model), model


def _live_devices() -> int:
    """The ranks of the initialized process group, else the visible
    cards."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count()


@dataclasses.dataclass
class ElasticController:
    """Restores training state onto whatever ranks are still alive."""

    ckpt: CheckpointManager
    make_mesh: Callable[[int, int], object]     # (data, model) → DeviceMesh
    model_parallel: int = 1

    def resume(self, tree_like, sharding_fn=None):
        """Returns (mesh, state, step) for the current device count.

        ``sharding_fn(mesh, tree_like)`` → a tree of DTensor placements
        (``sharding.param_specs`` gives one); each restored leaf is then
        distributed over ``mesh`` with its placements.  Without it the
        state keeps the manager's numpy leaves (replicated).
        """
        data, model = choose_mesh_shape(_live_devices(), self.model_parallel)
        mesh = self.make_mesh(data, model)
        step = self.ckpt.latest_step()
        if step is None:
            return mesh, None, 0
        state = self.ckpt.restore(step, tree_like)
        if sharding_fn is not None:
            from torch.distributed.tensor import distribute_tensor
            place = sharding_fn(mesh, tree_like)
            device = torch.device(mesh.device_type)

            def walk(leaf, spec):
                if isinstance(leaf, dict):
                    return {k: walk(v, spec[k]) for k, v in leaf.items()}
                if isinstance(leaf, (list, tuple)):
                    return type(leaf)(walk(v, s) for v, s in zip(leaf, spec))
                return distribute_tensor(
                    torch.as_tensor(leaf, device=device), mesh, spec)

            state = walk(state, place)
        return mesh, state, step


class PreemptionFlusher:
    """SIGTERM → save a final checkpoint before the scheduler kills us.
    The port's manager saves synchronously, so there is nothing to wait
    for after the save."""

    def __init__(self, ckpt: CheckpointManager):
        self.ckpt = ckpt
        self.preempted = False
        self._state = None
        self._step = 0
        signal.signal(signal.SIGTERM, self._handler)

    def update(self, step: int, state) -> None:
        self._step, self._state = step, state

    def _handler(self, signum, frame) -> None:
        self.preempted = True
        if self._state is not None:
            self.ckpt.save(self._step, self._state,
                           meta={"preempted": True})
