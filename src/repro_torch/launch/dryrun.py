"""Production-mesh dry run on the CPU: no card, no allocation.

Port of ``repro/launch/dryrun.py``.  For an (architecture × input shape)
cell it traces the step a deployment would run, on the production mesh
(256 H100s as ("data", "model") = (32, 8), or 512 with a "pod" axis), and
reports one device's work and memory:

  * the train step (AdamW with ``optimizer_state_dtype`` moments) for train
    shapes, prefill for prefill shapes, and one decode step against a
    ``seq_len`` cache for decode shapes;
  * traced under ``FakeTensorMode`` on a ``"fake"`` process group (rank 0
    of the mesh's world), with device type "cpu": tensors carry shapes and
    dtypes and no data, so the 398B configs cost nothing;
  * parameters and optimizer state are DTensors placed by ``param_specs``,
    inputs by ``input_specs_for``'s axes under ``_rules_for`` (the
    reference's per-arch and per-shape rules), and the model's ``shard()``
    calls lay activations out as the reference's sites do;
  * a batch its mesh axes do not divide (prefill_32k's 32 on the (2, 32, 8)
    mesh's 64 batch shards) is padded up to their multiple, as GSPMD pads:
    the record keeps ``tokens`` at the real batch and names
    ``padded_batch``.

Counts, per device as the reference's ``cost_analysis`` reports them:
  * ``flops``: ``torch.utils.flop_counter``'s formulas on the local ops
    each rank runs, plus the LM kernels' own counts (``*_work``, through
    the kernels' shape-only route, never their plain versions' ops);
  * ``bytes_accessed``: each local op's input and output bytes (the eager
    program does not fuse), views and fresh allocations excluded, plus the
    kernels' counts;
  * ``memory``: ``argument_size_in_bytes`` from the placed shards,
    ``peak_bytes`` the most bytes of local storages the rank holds live at
    once (``memory_tracker``: its placed shards, then each op's fresh
    outputs until they are freed), ``temp`` the peak above the arguments;
  * ``collectives``: the collectives ``CommDebugMode`` recorded, by op kind
    and mesh axis (``launch/roofline.py``).

Every layer is traced (``cost_source: "traced, every layer"``): the port
loops over layers, so there is no scan body to extrapolate from.  Importing
this module sets nothing: unlike the reference's, it leaves every
environment variable alone.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --arch … --shape … --multi-pod
    python -m repro_torch.launch.dryrun --all --out results/dryrun [--jobs 2]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

__all__ = ["run_cell", "main", "fake_world", "step_counter"]


def _rules_for(arch: str, shape, multi_pod: bool) -> Dict:
    """Per-arch overrides + per-shape adjustments (see configs/<arch>.py);
    ``shape`` a name of ``SHAPES`` or a ``ShapeSpec``."""
    from ..configs import SHAPES, get
    spec = get(arch)
    cfg = spec.config
    rules = dict(spec.rules)
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    if cfg.fsdp and shp.kind == "train":
        # ZeRO-3 over the data axis — training only: gathering params every
        # serve step costs ~params/model_shards of wire per token; serving
        # keeps params model-sharded and resident.
        rules.setdefault("embed", "data")
    if shp.global_batch == 1:
        rules["batch"] = None                    # long_500k: nothing to split
    if shp.kind == "decode" and rules.get("kv_heads", "model") is None:
        # KV heads are replicated (kv=8 against the model axis): shard the
        # cache's sequence dim over "model" instead (flash-decoding style),
        # or the 32k/500k caches exceed one GPU's memory.
        rules["cache_seq"] = "model"
    return rules


# ------------------------------------------------------------- the world
@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``"fake"`` default process group of ``world_size`` ranks (this
    process is rank 0; collectives return at once), destroyed on exit.
    The one place the dry run creates and tears down its process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dry run: a process group is already initialised "
                           "in this process; run the dry run in a process "
                           "of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the counters
def _op_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _ours(ts, fake_mode) -> bool:
    """Whether an op on ``ts`` is one the rank runs: not one on the meta
    device or on fake tensors of another mode than ``fake_mode`` (DTensor's
    sharding propagation makes its global-shape stand-ins so)."""
    from torch._subclasses.fake_tensor import FakeTensor
    for t in ts:
        if t.device.type == "meta":
            return False
        if isinstance(t, FakeTensor) and t.fake_mode is not fake_mode:
            return False
    return True


#: ops that move no bytes although their schema marks no alias: fresh
#: allocations, and ``_unsafe_view`` (the view a reshape or a matmul takes
#: of a tensor it made)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_unsafe_view"}


def step_counter(fake_mode=None):
    """A dispatch mode counting one rank's local ops: FLOPs by
    ``torch.utils.flop_counter``'s formulas, bytes as each op's inputs and
    outputs.  DTensor-level ops return ``NotImplemented``, so DTensor runs
    them and the mode sees the local ops they become (sharding propagation's
    own fake tensors, of another fake mode, are skipped); ops of the
    kernels' plain versions under ``COUNTER.suppressed()`` are skipped, as
    are views, fresh allocations and collectives.  Classes are made here,
    so that importing this module imports no ``torch.distributed``."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    from ..kernels._work import COUNTER

    class _Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.fake_mode = fake_mode
            self.flops = 0.0
            self.bytes = 0.0
            self.by_op: Dict[str, float] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = _tensors((args, kwargs))
            if any(isinstance(t, DTensor) for t in ins):
                return NotImplemented
            out = func(*args, **kwargs)
            if COUNTER.suppress:
                return out
            outs = _tensors(out)
            if not _ours(ins + outs, self.fake_mode):
                return out
            ns = func.namespace
            if ns not in ("aten", "prims"):
                return out
            name = func._schema.name.split("::")[-1]
            pkt = func._overloadpacket
            if pkt in flop_registry:
                f = flop_registry[pkt](*args, **kwargs, out_val=out)
                self.flops += f
                self.by_op[str(pkt)] = self.by_op.get(str(pkt), 0) + f
            rets = func._schema.returns
            view = any(r.alias_info is not None
                       and not r.alias_info.is_write for r in rets)
            if not view and name not in _NO_BYTES:
                self.bytes += _op_bytes(ins) + _op_bytes(outs)
            return out

    return _Mode()


def memory_tracker(fake_mode=None):
    """A dispatch mode counting the bytes of one rank's live local storages,
    the same way on fake and on real tensors: :meth:`track` adds the placed
    arguments, each local op adds the storages of its outputs that it has
    not seen (a view or an in-place result adds nothing), and a storage
    leaves the count when it is freed.  ``peak`` is the largest count after
    any op.  It skips what ``step_counter`` skips: DTensor-level ops (it
    sees the local ops they become), ops under ``COUNTER.suppressed()``
    (the kernels' plain versions, sharding propagation), and tensors on the
    meta device or of another fake mode (propagation's global-shape
    stand-ins).  A collective's ``wait_tensor`` and ``_wrap_tensor_autograd``
    return their input (or an ``AsyncCollectiveTensor`` around it) in eager
    mode, so a fake one's fresh output is counted with its input's storage,
    and a wrapper is counted by the tensors it wraps."""
    import functools
    import weakref

    import torch
    # registers the functional collectives' ops, _wrap_tensor_autograd too
    import torch.distributed._functional_collectives  # noqa: F401
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import (
        TorchDispatchMode, is_traceable_wrapper_subclass)

    from ..kernels._work import COUNTER
    funcol = torch.ops._c10d_functional
    # ops whose eager result is their input (or a wrapper of it), though
    # their fake kernels make a fresh tensor
    aliasing = {getattr(funcol, n).default for n in (
        "wait_tensor", "_wrap_tensor_autograd") if hasattr(funcol, n)}

    class _Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = 0
            self.peak = 0
            # storage address → ([bytes, live storages], weak reference):
            # one entry is counted once, whatever storages share it
            self._seen = {}

        def _free(self, key, _ref):
            entry = self._seen.pop(key)[0]
            entry[1] -= 1
            if not entry[1]:
                self.live -= entry[0]

        def _add(self, t, entry=None):
            if is_traceable_wrapper_subclass(t):
                # a collective's AsyncCollectiveTensor: its own storage
                # holds nothing, the tensors it wraps do
                for name in t.__tensor_flatten__()[0]:
                    entry = self._add(getattr(t, name), entry)
                return entry
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                return self._seen[key][0]
            if entry is None:
                entry = [st.nbytes(), 0]
                self.live += entry[0]
            entry[1] += 1
            self._seen[key] = (entry, weakref.ref(
                st, functools.partial(self._free, key)))
            return entry

        def track(self, tensors):
            for t in tensors:
                self._add(t.to_local() if isinstance(t, DTensor) else t)
            self.peak = max(self.peak, self.live)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = _tensors((args, kwargs))
            if any(isinstance(t, DTensor) for t in ins):
                return NotImplemented
            out = func(*args, **kwargs)
            if COUNTER.suppress:
                return out
            outs = _tensors(out)
            if not _ours(ins + outs, fake_mode):
                return out
            entry = self._add(ins[0]) if func in aliasing else None
            for t in outs:
                self._add(t, entry)
            self.peak = max(self.peak, self.live)
            return out

    return _Mode()


@contextlib.contextmanager
def _propagation_uncounted():
    """DTensor's sharding propagation computes shard sizes and offsets with
    small tensor ops of its own; those are not the step's, and it runs them
    only for op signatures its cache has not seen, so counting them would
    make a count depend on what ran before.  While the block runs they go
    uncounted (``COUNTER.suppressed``)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from ..kernels._work import COUNTER
    name = "propagate_op_sharding_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        yield
        return

    def wrapped(self, *a, **k):
        with COUNTER.suppressed():
            return orig(self, *a, **k)
    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _collectives(mesh):
    """``CommDebugMode`` that also records each collective's bytes
    (max of operand and result, the reference's convention) and the mesh
    axis its group spans."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    groups = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        groups[mesh.get_group(i).group_name] = name
    kinds = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter",
             "all_to_all": "all-to-all", "permute": "collective-permute",
             "broadcast": "all-gather"}

    class _Mode(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.records = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(isinstance(t, DTensor)
                   for t in _tensors((args, kwargs))):
                return NotImplemented
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = str(func._overloadpacket)
            if "c10d" not in name or "wait" in name:
                return out
            kind = next((v for k, v in kinds.items() if k in name),
                        None)
            if kind is None:
                return out
            group = next((a for a in list(args) + list(
                (kwargs or {}).values()) if isinstance(a, str)
                and a in groups), None)
            size = max([_op_bytes([t]) for t in
                        _tensors((args, kwargs)) + _tensors(out)] or [0])
            self.records.append((kind, float(size),
                                 groups.get(group, "?")))
            return out

    return _Mode()


# --------------------------------------------------------------- placing
def _local_bytes(tree) -> int:
    """Bytes one rank holds of a tree of DTensors and plain tensors."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in _tensors(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def _placed(tree, specs, mesh, make):
    """Each tensor leaf of a meta tree as a DTensor over ``mesh`` with the
    placements at the same place in ``specs`` (as ``distribute_tree`` lays
    it out), its local shard made by ``make(shape, dtype)``: the rank holds
    its shard alone, never the whole tensor."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if isinstance(tree, torch.Tensor):
        shape, _ = compute_local_shape_and_global_offset(tree.shape, mesh,
                                                         specs)
        return DTensor.from_local(make(shape, tree.dtype), mesh, specs,
                                  run_check=False, shape=tree.shape,
                                  stride=tree.stride())
    if isinstance(tree, dict):
        return {k: _placed(v, specs[k], mesh, make) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_placed(v, sp, mesh, make)
                            for v, sp in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_placed(v, sp, mesh, make)
                          for v, sp in zip(tree, specs))
    return tree


def _shards(fake_mode, device, seed: int, high: int = 2):
    """A ``make`` for :func:`_placed`: empty shards of ``fake_mode``, or
    (``fake_mode`` None) real ones on ``device`` from ``seed``, integers in
    [0, ``high``) and the rest normal."""
    import torch
    if fake_mode is not None:
        def fake(shape, dtype):
            with fake_mode:
                return torch.empty(shape, dtype=dtype)
        return fake
    gen = torch.Generator(device).manual_seed(seed)

    def make(shape, dtype):
        if dtype.is_floating_point:
            return torch.empty(shape, dtype=dtype, device=device).normal_(
                generator=gen)
        return torch.randint(0, high, shape, generator=gen, dtype=dtype,
                             device=device)
    return make


def _quantized_abstract(params, specs, mesh):
    """The int8 tree of a meta parameter tree (``abstract_quantized``) and
    its placements (``quantize_spec_tree`` over the resolved specs)."""
    from ..distributed.sharding import placements_for
    from ..models.params import tree_map
    from ..models.quantize import (QTensor, abstract_quantized,
                                   quantize_spec_tree)
    qspecs = quantize_spec_tree(params, specs, mesh)

    def place(s):
        if isinstance(s, QTensor):
            return QTensor(placements_for(s.data, mesh),
                           placements_for(s.scale, mesh))
        return placements_for(s, mesh)
    # a resolved spec is a tuple, and so is a QTensor of two
    return abstract_quantized(params), tree_map(
        place, qspecs, is_leaf=lambda x: isinstance(x, tuple))


# ------------------------------------------------------------ the steps
def _run_step(cfg, shp, cell, mesh, rules, fake_mode, optimizer=None,
              ssd_chunk: int = 256, device: str = "cpu"):
    """Place the step's inputs, then run it under the counters → (record
    of counts and memory, the step's outputs, its inputs).  ``fake_mode``
    None runs it on real tensors on ``device`` (on the CPU the kernels'
    counted route, on a card the kernels themselves), random weights and
    tokens from seeds 0–2; on a card the record's memory also holds
    ``max_memory_allocated`` over the step (what the process held at most,
    its other tensors and the libraries' workspaces too).  A train step
    updates with ``optimizer`` (default: AdamW at
    ``cfg.optimizer_state_dtype``)."""
    import torch

    from ..distributed.sharding import (_map_axes, logical_spec,
                                        param_specs, placements_for,
                                        spec_tree, use_rules, with_rules)
    from ..kernels._work import COUNTER
    from ..models import abstract_params, param_axes
    from ..models import lm as lm_mod
    from ..optim import adamw
    from ..optim.adamw import OptState

    rules_full = with_rules(rules)

    def in_place(axes):
        return placements_for(logical_spec(axes, rules_full, mesh), mesh)

    quantized = cfg.quantize_weights and shp.kind != "train"
    params_meta = abstract_params(cfg)
    if quantized:
        params_meta, p_specs = _quantized_abstract(
            params_meta, spec_tree(param_axes(cfg), mesh, rules), mesh)
    else:
        p_specs = param_specs(param_axes(cfg), mesh, rules)
    inputs = {k: v for k, v in cell["specs"].items() if k != "index"}
    cuda = fake_mode is None and torch.device(device).type == "cuda"

    def shards(key):
        ids = key in ("tokens", "labels")
        return _shards(fake_mode, device, 2 if ids else 1,
                       cfg.vocab_size if ids else 2)
    # the mode is entered only to make the shards: their shapes are found
    # by tensor ops on the mesh's coordinates, which a fake tensor cannot
    # answer
    params = _placed(params_meta, p_specs, mesh,
                     _shards(fake_mode, device, 0))
    batch = {k: _placed(v, _map_axes(in_place, cell["axes"][k]), mesh,
                        shards(k)) for k, v in inputs.items()}
    mode = fake_mode or contextlib.nullcontext()
    state_bytes = {}
    with mode:
        if shp.kind == "train":
            opt = optimizer or adamw(1e-4, state_dtype=(
                torch.bfloat16 if cfg.optimizer_state_dtype == "bfloat16"
                else torch.float32))
            # the step counter as a Python int: the update reads it on the
            # host, which a fake tensor cannot answer
            st = opt.init(params)
            args = (lm_mod.TrainState(params, OptState(0, st.mu, st.nu), 0),
                    batch)
            state_bytes = {"params": _local_bytes(params),
                           "opt_state": _local_bytes((st.mu, st.nu))}

            def update(grads, state, params=None):
                state_bytes["grads"] = _local_bytes(grads)
                return opt.update(grads, state, params)
            step_fn = lm_mod.make_train_step(
                cfg, type(opt)(opt.init, update), ssd_chunk=ssd_chunk)
            grad = True
        elif shp.kind == "prefill":
            args = (params, batch["tokens"])

            def step_fn(p, tokens):
                return lm_mod.prefill(p, cfg, tokens,
                                      vision_embeds=batch.get(
                                          "vision_embeds"),
                                      ssd_chunk=ssd_chunk)
            grad = False
        else:
            args = (params, batch["tokens"], batch["caches"],
                    shp.seq_len - 1)

            def step_fn(p, tokens, caches, index):
                return lm_mod.decode_step(p, cfg, tokens, caches, index)
            grad = False
    arg_bytes = _local_bytes(args)
    counter = step_counter(fake_mode)
    comms = _collectives(mesh)
    mem = memory_tracker(fake_mode)
    mem.track(_tensors(args))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the fake mode is not entered: the fake tensors carry it into every op,
    # and DTensor's sharding propagation, finding no active fake mode,
    # makes its global-shape stand-ins in a mode of its own, which the
    # counters skip
    with mem, comms, counter, use_rules(mesh, rules), COUNTER.counting(), \
            _propagation_uncounted(), torch.set_grad_enabled(grad):
        out = step_fn(*args)
    memory = {"temp_size_in_bytes": max(0, mem.peak - arg_bytes),
              "argument_size_in_bytes": arg_bytes,
              "output_size_in_bytes": _local_bytes(out),
              "alias_size_in_bytes": 0,
              "peak_bytes": mem.peak}
    if cuda:
        torch.cuda.synchronize()
        memory["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    kflops, kbytes = COUNTER.total()
    return {
        "flops": counter.flops + kflops,
        "bytes_accessed": counter.bytes + kbytes,
        "aten_flops": counter.flops, "aten_bytes": counter.bytes,
        "kernels": {k: {"flops": COUNTER.flops[k],
                        "bytes": COUNTER.bytes[k],
                        "calls": COUNTER.calls[k]} for k in COUNTER.flops},
        "memory": memory,
        "state_bytes": state_bytes,
        "collective_records": comms.records,
        "comm_counts": {str(k): v for k, v in
                        comms.get_comm_counts().items()},
    }, out, args


def _batch_shards(rules: Dict, axes, dims) -> int:
    """The product of the mesh dims the logical "batch" axis shards over."""
    from ..distributed.sharding import with_rules
    mapped = with_rules(rules).get("batch")
    names = (mapped,) if isinstance(mapped, str) else (mapped or ())
    n = 1
    for name, size in zip(axes, dims):
        if name in names:
            n *= size
    return n


def run_cell(arch: str, shape, multi_pod: bool = False,
             extra_rules: Optional[Dict] = None,
             config_overrides: Optional[Dict] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             config=None, real: bool = False, optimizer=None,
             ssd_chunk: int = 256, device: str = "cpu") -> Dict:
    """The dry run of one cell → the reference's record keys.

    ``shape`` is a name of ``SHAPES`` or a ``ShapeSpec`` (``chip_smoke.py``
    dry-runs its own training shapes).  ``mesh_shape`` replaces the
    production mesh's shape (same axis names), e.g. (1, 1) for one GPU;
    ``config`` replaces the arch's registered config (a cut one).
    ``real`` runs the same count on real tensors on ``device`` (random
    weights and tokens; the fake process group's collectives move no data
    but allocate their outputs): on the CPU, which a small config affords,
    the kernels take their counted route, so its counts and peak must
    equal the fake run's; on a card (``"cuda"``, the mesh's device type
    too) the kernels launch, adding no work to the counts, and the record's
    memory holds what this rank allocated at most over the step
    (``max_memory_allocated``) beside the peak.  ``optimizer`` replaces the train
    step's AdamW (a launcher's own; its ``init`` must work on DTensors)
    and ``ssd_chunk`` is the Mamba-2 chunk the step runs at."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..configs import SHAPES, get
    from ..configs.registry import input_specs_for
    from .mesh import make_production_mesh, mesh_name, production_shape
    from .roofline import collective_bytes

    t0 = time.time()
    spec = get(arch)
    cfg = config or spec.config
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    if shp.name in spec.skip:
        return {"arch": arch, "shape": shp.name,
                "skipped": spec.skip[shp.name]}
    rules = _rules_for(arch, shp, multi_pod)
    if extra_rules:
        rules.update(extra_rules)
    prod, axes = production_shape(multi_pod)
    dims = tuple(mesh_shape or prod)
    n_dev = 1
    for n in dims:
        n_dev *= n
    cell = input_specs_for(cfg, shp, _batch_shards(rules, axes, dims))
    result = {
        "arch": arch, "shape": shp.name, "kind": shp.kind,
        "tokens": shp.global_batch * (1 if shp.kind == "decode"
                                      else shp.seq_len),
        "mesh": mesh_name(dims), "num_devices": n_dev,
        "params": cfg.num_params(),
        "active_params": cfg.active_params(),
        "rules": {k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in rules.items()},
    }
    if cell["batch"] != shp.global_batch:
        # the step ran on the padded batch; "tokens" stays the real work
        result["padded_batch"] = cell["batch"]
    dev = device if real else "cpu"
    with fake_world(n_dev):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=dev)
        else:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(dev, dims, mesh_dim_names=axes)
        t = time.time()
        rec, _, _ = _run_step(
            cfg, shp, cell, mesh, rules,
            None if real else FakeTensorMode(allow_non_fake_inputs=True),
            optimizer=optimizer, ssd_chunk=ssd_chunk, device=dev)
        result["compile_scanned_s"] = round(time.time() - t, 2)
    result["memory"] = rec["memory"]
    if rec["state_bytes"]:
        result["state_bytes"] = rec["state_bytes"]
    result["flops"] = rec["flops"]
    result["bytes_accessed"] = rec["bytes_accessed"]
    result["collectives"] = collective_bytes(rec["collective_records"])
    result["comm_counts"] = rec["comm_counts"]
    result["kernels"] = rec["kernels"]
    result["aten_flops"] = rec["aten_flops"]
    result["aten_bytes"] = rec["aten_bytes"]
    result["cost_source"] = "traced, every layer"
    result["total_s"] = round(time.time() - t0, 2)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--rules", default=None,
                    help="JSON dict of extra logical→mesh rule overrides, "
                         "e.g. '{\"res_seq\": \"model\"}'")
    ap.add_argument("--tag", default=None,
                    help="suffix for the output JSON (perf variants)")
    args = ap.parse_args(argv)

    if args.all:
        return _run_all(args.out, jobs=args.jobs)

    extra = json.loads(args.rules) if args.rules else None
    res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   extra_rules=extra)
    print(json.dumps(res, indent=2, default=str))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"__{args.tag}" if args.tag else ""
        name = f"{args.arch}__{args.shape}__{res.get('mesh', 'skip')}{tag}.json"
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(res, f, indent=2, default=str)
    return 0


def _run_all(out_dir: str, jobs: int = 1) -> int:
    """Drive every (arch × shape × mesh) cell in worker subprocesses (one
    process group each)."""
    import subprocess
    from ..configs import SHAPES, all_archs, get
    from .mesh import mesh_name, production_shape

    os.makedirs(out_dir, exist_ok=True)
    cells = []
    for arch in all_archs():
        spec = get(arch)
        for shape in SHAPES:
            if shape in spec.skip:
                path = os.path.join(out_dir, f"{arch}__{shape}__skip.json")
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape,
                               "skipped": spec.skip[shape]}, f, indent=2)
                continue
            for multi in (False, True):
                mesh = mesh_name(production_shape(multi)[0])
                path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
                if os.path.exists(path):
                    continue
                cells.append((arch, shape, multi, path))

    running = []
    failures = []

    def _drain(block_all=False):
        while running and (block_all or len(running) >= jobs):
            done = None
            for i, (proc, meta, log) in enumerate(running):
                if proc.poll() is not None:
                    done = i
                    break
            if done is None:
                time.sleep(2.0)
                continue
            proc, meta, log = running.pop(done)
            log.close()
            if proc.returncode != 0:
                failures.append(meta)
                print(f"FAIL {meta}", flush=True)
            else:
                print(f"ok   {meta}", flush=True)

    for arch, shape, multi, path in cells:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", out_dir]
        if multi:
            cmd.append("--multi-pod")
        logf = open(path.replace(".json", ".log"), "w")
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT)
        running.append((proc, (arch, shape, multi), logf))
        _drain()
    _drain(block_all=True)
    print(f"done; {len(failures)} failures")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
