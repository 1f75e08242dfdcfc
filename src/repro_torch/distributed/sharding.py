"""Logical-axis sharding: rules tables that map logical names to mesh axes.

Port of ``repro/distributed/sharding.py``.  Code annotates tensors with
*logical* axis names ("batch", "heads", "graphs", ...); a rules table maps
each name to mesh axes, so the same code runs unsharded (no rules context),
data-parallel, tensor-parallel or over the rollout grid's ("graphs",
"chains") mesh.

The reference resolves a logical spec to a JAX ``PartitionSpec``; here
:func:`logical_spec` returns the same per-axis entries as a plain tuple
(``None``, a mesh axis name, or a tuple of names), mesh axes absent from
the mesh dropped.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
(anything with ``mesh_dim_names``), and :func:`param_specs` turns a spec
into DTensor placements (``Shard(dim)`` or ``Replicate()`` for each mesh
dim).  DTensor is imported only by the functions that build placements.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple, Union

__all__ = ["AxisRules", "DEFAULT_RULES", "ROLLOUT_RULES", "use_rules",
           "logical_spec", "shard", "gather_params", "param_specs",
           "spec_tree", "placements_for", "distribute_tree", "current_mesh",
           "with_rules"]

MeshAxes = Union[None, str, Tuple[str, ...]]
AxisRules = dict

#: baseline production rules for the (pod, data, model) / (data, model) meshes
DEFAULT_RULES: AxisRules = {
    # data-parallel dims
    "batch": ("pod", "data"),
    "group": ("pod", "data"),
    # tensor-parallel dims
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",      # EP; expert hidden stays unsharded by default
    "expert_mlp": None,      # (mixtral: experts→None + expert_mlp→"model")
    "state": None,
    # replicated-by-default dims
    "embed": None,        # param d_model dim (→ "data" under FSDP)
    "act_embed": None,    # activation d_model dim
    "act_seq": None,      # activation sequence dim inside mixer/ffn compute
    "res_seq": None,      # residual-stream sequence dim (→ "model" under
                          # sequence parallelism)
    "layers": None,
    "head_dim": None,
    "conv": None,
    "capacity": None,
    "qkv": None,
    "merged_bh": ("data", "model"),   # head-merged attention (config flag)
    "cache_seq": None,
}

#: logical axes of the (G, B) rollout grid: the 2-D ("graphs", "chains")
#: mesh :class:`~repro_torch.core.sim.sharded.ShardedRolloutEngine` tiles.
#: "time" (the window step axis) is never sharded.
ROLLOUT_RULES: AxisRules = {
    "graphs": "graphs",
    "chains": "chains",
    "time": None,
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[AxisRules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[AxisRules] = None):
    """Activate a mesh + logical rules for :func:`shard`, with DTensor's
    implicit replication of plain tensors.

    Nesting-safe under exceptions: the merged rules table is built before
    the context is touched (a bad ``rules`` mapping raises with the outer
    context intact), and both slots are restored in one ``finally``.
    """
    merged = dict(DEFAULT_RULES, **(rules or {}))
    prev = (_CTX.mesh, _CTX.rules)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            # constants the model makes (positions, masks) meet DTensor
            # activations as replicated tensors
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(implicit_replication())
        _CTX.mesh, _CTX.rules = mesh, merged
        try:
            yield
        finally:
            _CTX.mesh, _CTX.rules = prev


def with_rules(rules: Optional[AxisRules]) -> AxisRules:
    return dict(DEFAULT_RULES, **(rules or {}))


def current_mesh():
    return _CTX.mesh


def _resolve(axes: Sequence[Optional[str]], rules: AxisRules,
             mesh) -> Tuple[MeshAxes, ...]:
    parts = []
    for a in axes:
        m = rules.get(a) if a is not None else None
        if m is None:
            parts.append(None)
            continue
        if mesh is not None:
            # Drop mesh axes absent from this mesh (e.g. "pod" on one pod)
            names = tuple(mesh.mesh_dim_names or ())
            if isinstance(m, tuple):
                m = tuple(x for x in m if x in names) or None
            elif m not in names:
                m = None
        parts.append(m)
    return tuple(parts)


def logical_spec(axes: Sequence[Optional[str]],
                 rules: Optional[AxisRules] = None,
                 mesh=None) -> Tuple[MeshAxes, ...]:
    """The mesh axes of each logical axis in ``axes`` (the entries of the
    reference's ``PartitionSpec``), under ``rules`` (default: the active
    context's, else :data:`DEFAULT_RULES`) on ``mesh`` (default: the
    active context's)."""
    rules = rules if rules is not None else (_CTX.rules or DEFAULT_RULES)
    mesh = mesh if mesh is not None else _CTX.mesh
    return _resolve(axes, rules, mesh)


def placements_for(spec: Sequence[MeshAxes], mesh) -> list:
    """A resolved spec → DTensor placements over ``mesh``: ``Shard(d)`` on
    each mesh dim that tensor dim d maps to, ``Replicate()`` elsewhere.  A
    tensor dim mapped to several mesh axes is sharded over each of them in
    mesh-dim order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, m in enumerate(spec):
        for axis in ((m,) if isinstance(m, str) else (m or ())):
            i = names.index(axis)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {axis!r} shards two tensor "
                                 f"dims in {tuple(spec)}")
            out[i] = Shard(dim)
    return out


def shard(x, *axes: Optional[str]):
    """Lay ``x`` out as its logical axes say on the active mesh: a DTensor
    is redistributed, a plain tensor (the same on every rank) is taken as
    replicated and then laid out, both differentiably.  The identity
    outside a :func:`use_rules` context, at the cost of one attribute
    check.  The model calls it at the reference's sites
    (``models/layers.py``, ``models/lm.py``, ``models/ssm.py``).
    """
    if _CTX.mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    mesh = _CTX.mesh
    place = placements_for(_resolve(axes, _CTX.rules, mesh), mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == tuple(place):
        return x
    return x.redistribute(mesh, place)


def gather_params(tree):
    """FSDP's all-gather: the DTensor leaves of a parameter (sub)tree made
    whole along the mesh axes the batch shards over (the rules' "batch":
    "pod" and "data"), just before the layer that reads them; their
    gradients go back as the matching reduce-scatter.  Without it DTensor
    would meet a weight split on "data" against a batch split on "data" by
    moving the activations instead.  The identity outside
    :func:`use_rules`, and for every leaf no such axis shards (all rule
    sets but FSDP's)."""
    if _CTX.mesh is None:
        return tree
    mesh = _CTX.mesh
    names = list(mesh.mesh_dim_names)
    batch = _resolve(("batch",), _CTX.rules, mesh)[0]
    dims = {names.index(a) for a in ((batch,) if isinstance(batch, str)
                                     else batch or ())}
    if not dims:
        return tree
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def leaf(t):
        if not isinstance(t, DTensor) or not any(
                i in dims and isinstance(p, Shard)
                for i, p in enumerate(t.placements)):
            return t
        return t.redistribute(mesh, [Replicate() if i in dims else p
                                     for i, p in enumerate(t.placements)])

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return leaf(node)
    return walk(tree)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _map_axes(fn, axes_tree):
    if _is_axes(axes_tree):
        return fn(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v) for k, v in axes_tree.items()}
    if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(_map_axes(fn, v) for v in axes_tree))
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(_map_axes(fn, v) for v in axes_tree)
    raise TypeError(f"param_specs: unexpected leaf {axes_tree!r}")


def spec_tree(axes_tree, mesh, rules: Optional[AxisRules] = None):
    """Map a logical-axes tree to the resolved specs (the reference's
    ``PartitionSpec`` entries) of each leaf on ``mesh``."""
    rules = with_rules(rules)
    return _map_axes(lambda a: _resolve(a, rules, mesh), axes_tree)


def param_specs(axes_tree, mesh, rules: Optional[AxisRules] = None):
    """Map a logical-axes tree (dicts, lists and NamedTuples whose leaves
    are tuples of logical names) to a tree of DTensor placements on
    ``mesh``."""
    rules = with_rules(rules)
    return _map_axes(lambda a: placements_for(_resolve(a, rules, mesh), mesh),
                     axes_tree)


def distribute_tree(tree, specs, mesh):
    """Each tensor leaf of ``tree`` (dicts, lists, NamedTuples), the same
    on every rank, as a DTensor with the placements at the same place in
    ``specs`` (``param_specs``' output): each rank keeps its slice, with no
    communication."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, specs, src_data_rank=None)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute_tree(v, sp, mesh)
                            for v, sp in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, sp, mesh)
                          for v, sp in zip(tree, specs))
    return tree
