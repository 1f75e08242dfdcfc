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
    calls lay activations out as the reference's sites do.

Counts, per device as the reference's ``cost_analysis`` reports them:
  * ``flops``: ``torch.utils.flop_counter``'s formulas on the local ops
    each rank runs, plus the LM kernels' own counts (``*_work``, through
    the kernels' shape-only route, never their plain versions' ops);
  * ``bytes_accessed``: each local op's input and output bytes (the eager
    program does not fuse), views and fresh allocations excluded, plus the
    kernels' counts;
  * ``memory``: ``argument_size_in_bytes`` from the placed shards, the peak
    from ``MemTracker``, ``temp`` the peak above the arguments;
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

        def _ours(self, ts) -> bool:
            from torch._subclasses.fake_tensor import FakeTensor
            for t in ts:
                if t.device.type == "meta":
                    return False
                if isinstance(t, FakeTensor) and \
                        t.fake_mode is not self.fake_mode:
                    return False
            return True

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = _tensors((args, kwargs))
            if any(isinstance(t, DTensor) for t in ins):
                return NotImplemented
            out = func(*args, **kwargs)
            if COUNTER.suppress:
                return out
            outs = _tensors(out)
            if not self._ours(ins + outs):
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


def _materialize(meta_tree, fake_mode, seed: int = 0):
    """Tensors of the shapes and dtypes of a meta tree: fake ones under
    ``fake_mode``, or (``fake_mode`` None) real CPU ones from ``seed``:
    integer leaves in [0, 2), the rest normal (token ids are drawn by the
    caller)."""
    import torch
    from ..models.params import tree_map
    if fake_mode is not None:
        with fake_mode:
            return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype)
                            if isinstance(t, torch.Tensor) else t, meta_tree)
    gen = torch.Generator().manual_seed(seed)

    def real(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen).to(t.dtype)
        return torch.randint(0, 2, t.shape, generator=gen).to(t.dtype)
    return tree_map(real, meta_tree)


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
              ssd_chunk: int = 256):
    """Place the step's inputs, then run it under the counters → (record
    of counts and memory, the step's outputs, its inputs).  ``fake_mode``
    None runs it on real CPU tensors (the kernels' counted route), random
    weights and tokens from seed 0.  A train step updates with
    ``optimizer`` (default: AdamW at ``cfg.optimizer_state_dtype``)."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker

    from ..distributed.sharding import (_map_axes, distribute_tree,
                                        logical_spec, param_specs,
                                        placements_for, spec_tree,
                                        use_rules, with_rules)
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
    params = _materialize(params_meta, fake_mode)
    inputs = _materialize(inputs, fake_mode, seed=1)
    if fake_mode is None:
        gen = torch.Generator().manual_seed(2)
        for k in ("tokens", "labels"):
            if k in inputs:
                inputs[k] = torch.randint(0, cfg.vocab_size,
                                          inputs[k].shape, generator=gen,
                                          dtype=torch.int32)
    mode = fake_mode or contextlib.nullcontext()
    with mode:
        params = distribute_tree(params, p_specs, mesh)
        batch = {k: distribute_tree(
            v, _map_axes(in_place, cell["axes"][k]), mesh)
            for k, v in inputs.items()}
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
    mem = MemTracker()
    mem.track_external(*[t for t in _tensors(args)])
    # the fake mode is not entered: the fake tensors carry it into every op,
    # and DTensor's sharding propagation, finding no active fake mode,
    # makes its global-shape stand-ins in a mode of its own, which the
    # counter skips
    with mem, comms, counter, use_rules(mesh, rules), COUNTER.counting(), \
            _propagation_uncounted(), torch.set_grad_enabled(grad):
        out = step_fn(*args)
    peak = mem.get_tracker_snapshot("peak")
    peak_total = max((v.get("Total", 0) for v in peak.values()), default=0)
    kflops, kbytes = COUNTER.total()
    return {
        "flops": counter.flops + kflops,
        "bytes_accessed": counter.bytes + kbytes,
        "aten_flops": counter.flops, "aten_bytes": counter.bytes,
        "kernels": {k: {"flops": COUNTER.flops[k],
                        "bytes": COUNTER.bytes[k],
                        "calls": COUNTER.calls[k]} for k in COUNTER.flops},
        "memory": {"temp_size_in_bytes": max(0, peak_total - arg_bytes),
                   "argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": _local_bytes(out),
                   "alias_size_in_bytes": 0,
                   "peak_bytes": peak_total},
        "state_bytes": state_bytes,
        "collective_records": comms.records,
        "comm_counts": {str(k): v for k, v in
                        comms.get_comm_counts().items()},
    }, out, args


def run_cell(arch: str, shape, multi_pod: bool = False,
             extra_rules: Optional[Dict] = None,
             config_overrides: Optional[Dict] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             config=None, real: bool = False, optimizer=None,
             ssd_chunk: int = 256) -> Dict:
    """The dry run of one cell → the reference's record keys.

    ``shape`` is a name of ``SHAPES`` or a ``ShapeSpec`` (``chip_smoke.py``
    dry-runs its own training shapes).  ``mesh_shape`` replaces the
    production mesh's shape (same axis names), e.g. (1, 1) for one GPU;
    ``config`` replaces the arch's registered config (a cut one).
    ``real`` runs the same count on real CPU tensors (random weights and
    tokens; the fake process group's collectives move no data), which a
    small config affords: the kernels take their counted route, so its
    counts must equal the fake run's.  ``optimizer`` replaces the train
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
    cell = input_specs_for(cfg, shp)
    rules = _rules_for(arch, shp, multi_pod)
    if extra_rules:
        rules.update(extra_rules)
    prod, axes = production_shape(multi_pod)
    dims = tuple(mesh_shape or prod)
    n_dev = 1
    for n in dims:
        n_dev *= n
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
    with fake_world(n_dev):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
        else:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=axes)
        t = time.time()
        rec, _, _ = _run_step(
            cfg, shp, cell, mesh, rules,
            None if real else FakeTensorMode(allow_non_fake_inputs=True),
            optimizer=optimizer, ssd_chunk=ssd_chunk)
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
