"""The LM kernels' work counts, and the routes that count them.

Each LM kernel (``rmsnorm``, ``flash_attention``, ``ssd_scan``) has a
``*_work(shapes…, backward=False) -> (flops, bytes)``: the operations its
forward (or backward) does and the bytes it must move, each input read once
and each output written once.  ``chip_smoke.py``'s bound column and the dry
run (``launch/dryrun.py``) both read them, so a kernel's work is counted the
same way whatever runs it.

Two routes of each wrapper count the work instead of, or beside, the plain
version:

* **shape-only**: a fake tensor (the dry run under ``FakeTensorMode``),
  or a meta tensor while :data:`COUNTER` is active, allocates outputs of the right shape and dtype under
  the active mode, so that a memory tracker sees them, and adds the work to
  :data:`COUNTER`.  It never runs the plain version, whose (S, S) scores at
  a 32k prefill would count memory and FLOPs the kernel never spends;
* **counted**: while :data:`COUNTER` is active, a real CPU tensor runs the
  plain version with the counter's op count suspended
  (:meth:`WorkCounter.suppressed`) and adds the kernel's work in its place,
  forward and backward, so that a count taken on real tensors equals the
  dry run's.

Outside an active counter, CPU tensors take the plain version, CUDA
tensors the kernel, and a tensor on any other device raises, as always.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import torch

__all__ = ["WorkCounter", "COUNTER", "is_shape_only", "is_dtensor",
           "KernelSpec", "counted_call", "causal_pairs"]


class WorkCounter:
    """The kernels' work while active: FLOPs and bytes per kernel name
    (``name`` forward, ``name_bwd`` backward) and calls."""

    def __init__(self):
        self.active = False
        self.suppress = 0
        self.reset()

    def reset(self) -> None:
        self.flops: Dict[str, float] = {}
        self.bytes: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def add(self, name: str, work: Tuple[float, float]) -> None:
        flops, nbytes = work
        self.flops[name] = self.flops.get(name, 0.0) + flops
        self.bytes[name] = self.bytes.get(name, 0.0) + nbytes
        self.calls[name] = self.calls.get(name, 0) + 1

    def total(self) -> Tuple[float, float]:
        return sum(self.flops.values()), sum(self.bytes.values())

    @contextlib.contextmanager
    def counting(self):
        """Reset, then count until the block ends."""
        prev = self.active
        self.reset()
        self.active = True
        try:
            yield self
        finally:
            self.active = prev

    @contextlib.contextmanager
    def suppressed(self):
        """Ops run here are the plain version's, not the step's: an op
        counter reading :attr:`suppress` skips them."""
        self.suppress += 1
        try:
            yield
        finally:
            self.suppress -= 1


COUNTER = WorkCounter()


def is_dtensor(t) -> bool:
    """A ``DTensor`` (only possible once ``torch.distributed.tensor`` is
    imported, so a plain run pays one type check)."""
    if type(t) is torch.Tensor:
        return False
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def is_shape_only(t) -> bool:
    """A fake or meta tensor: the kernels' shape-only route."""
    if type(t) is torch.Tensor:
        return t.device.type == "meta"
    from torch._subclasses.fake_tensor import is_fake
    return t.device.type == "meta" or is_fake(t)


def causal_pairs(s: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: the ones of
    ``flash_mask(s, causal, window)``."""
    if not causal:
        return s * s
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


class KernelSpec(NamedTuple):
    """One kernel call for :func:`counted_call`: its name, the plain
    version over the tensor inputs, the outputs' (shape, dtype), extra
    tensors its autograd Function saves (shape, dtype), and its work."""
    name: str
    plain: Callable
    outputs: Sequence[Tuple[Tuple[int, ...], torch.dtype]]
    saved: Sequence[Tuple[Tuple[int, ...], torch.dtype]]
    work: Callable[[bool], Tuple[float, float]]


class _Counted(torch.autograd.Function):
    """The shape-only and counted routes: the forward's outputs (empty
    under the active mode, or the plain version's), the work of the
    forward and, in the backward, of the backward."""

    @staticmethod
    def forward(ctx, spec: KernelSpec, *inputs):
        ctx.spec = spec
        ctx.shape_only = is_shape_only(inputs[0])
        COUNTER.add(spec.name, spec.work(False))
        # new_empty dispatches through the input, so a fake input's mode
        # makes the output even where the mode is not entered
        x = inputs[0]
        if ctx.shape_only:
            outs = tuple(x.new_empty(s, dtype=dt) for s, dt in spec.outputs)
        else:
            # contiguous, as the kernels write their outputs
            with COUNTER.suppressed(), torch.no_grad():
                outs = spec.plain(*inputs)
                outs = tuple(o.contiguous() for o in (
                    outs if isinstance(outs, tuple) else (outs,)))
        extra = tuple(x.new_empty(s, dtype=dt) for s, dt in spec.saved)
        ctx.save_for_backward(*inputs, *outs, *extra)
        ctx.n_in = len(inputs)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        inputs = ctx.saved_tensors[:ctx.n_in]
        COUNTER.add(spec.name + "_bwd", spec.work(True))
        need = ctx.needs_input_grad[1:]
        if ctx.shape_only:
            # contiguous, as the kernels write their gradients
            return (None,) + tuple(t.new_empty(t.shape) if n else None
                                   for t, n in zip(inputs, need))
        with COUNTER.suppressed(), torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
            outs = spec.plain(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            # an output the inputs do not reach (the state entering a
            # one-chunk scan) has no gradient to pass on
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [x for x, n in zip(xs, need) if n]
            got = torch.autograd.grad([o for o, _ in pairs], wrt,
                                      [g for _, g in pairs],
                                      allow_unused=True) \
                if pairs else [None] * len(wrt)
            got = iter([None if g is None else g.contiguous() for g in got])
        return (None,) + tuple(next(got) if n else None for n in need)


def counted_call(spec: KernelSpec, *inputs):
    """Run ``spec`` on the shape-only or counted route."""
    return _Counted.apply(spec, *inputs)
