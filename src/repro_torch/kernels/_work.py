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
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

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
    tensors its autograd Function saves (shape, dtype), its work, and the
    positions (among the inputs, then the outputs, then the extra tensors)
    of what that Function saves for its backward (None: all of them), so
    that the rest is freed when the kernel's would be."""
    name: str
    plain: Callable
    outputs: Sequence[Tuple[Tuple[int, ...], torch.dtype]]
    saved: Sequence[Tuple[Tuple[int, ...], torch.dtype]]
    work: Callable[[bool], Tuple[float, float]]
    saves: Optional[Sequence[int]] = None


class _Counted(torch.autograd.Function):
    """The shape-only and counted routes: the forward's outputs (empty
    under the active mode, or holding the plain version's), the work of the
    forward and, in the backward, of the backward."""

    @staticmethod
    def forward(ctx, spec: KernelSpec, *inputs):
        ctx.spec = spec
        ctx.shape_only = is_shape_only(inputs[0])
        COUNTER.add(spec.name, spec.work(False))
        # new_empty dispatches through the input, so a fake input's mode
        # makes the output even where the mode is not entered; both routes
        # allocate the outputs by it (contiguous, as the kernels write
        # them), so a memory tracker sees the same storages on each
        x = inputs[0]
        outs = tuple(x.new_empty(s, dtype=dt) for s, dt in spec.outputs)
        if not ctx.shape_only:
            with COUNTER.suppressed(), torch.no_grad():
                got = spec.plain(*inputs)
                for o, g in zip(outs, got if isinstance(got, tuple)
                                else (got,)):
                    o.copy_(g)
        extra = tuple(x.new_empty(s, dtype=dt) for s, dt in spec.saved)
        every = (*inputs, *outs, *extra)
        ctx.save_for_backward(*(every if spec.saves is None
                                else (every[i] for i in spec.saves)))
        ctx.like = [(t.shape, t.dtype) for t in inputs]
        if not ctx.shape_only:
            # the plain backward's inputs, copied where the op counters
            # and memory trackers do not look: the kernel keeps only
            # what it saves
            with COUNTER.suppressed():
                ctx.plain_inputs = tuple(t.detach().clone() for t in inputs)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        COUNTER.add(spec.name + "_bwd", spec.work(True))
        need = ctx.needs_input_grad[1:]
        # contiguous, as the kernels write their gradients
        x = ctx.saved_tensors[0]
        fresh = tuple(x.new_empty(shape, dtype=dt) if n else None
                      for (shape, dt), n in zip(ctx.like, need))
        if ctx.shape_only:
            return (None,) + fresh
        inputs = ctx.plain_inputs
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
            got = iter(got)
            grads = []
            for f in fresh:
                g = next(got) if f is not None else None
                grads.append(None if g is None else f.copy_(g))
        return (None,) + tuple(grads)


def counted_call(spec: KernelSpec, *inputs):
    """Run ``spec`` on the shape-only or counted route."""
    return _Counted.apply(spec, *inputs)
