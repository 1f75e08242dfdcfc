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
           "logical_spec", "shard", "param_specs", "current_mesh",
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
    """Activate a mesh + logical rules for :func:`shard`.

    Nesting-safe under exceptions: the merged rules table is built before
    the context is touched (a bad ``rules`` mapping raises with the outer
    context intact), and both slots are restored in one ``finally``.
    """
    merged = dict(DEFAULT_RULES, **(rules or {}))
    prev = (_CTX.mesh, _CTX.rules)
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


def _placements(spec: Sequence[MeshAxes], mesh) -> list:
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
    is redistributed, a plain tensor (the same on every rank) distributed.
    The identity outside a :func:`use_rules` context.

    Nothing in the port calls it yet: its first caller comes with the LM
    substrate's mesh (ROADMAP.md 'Modules to port' item 11).
    """
    if _CTX.mesh is None or _CTX.rules is None:
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor
    place = _placements(_resolve(axes, _CTX.rules, _CTX.mesh), _CTX.mesh)
    if isinstance(x, DTensor):
        return x.redistribute(_CTX.mesh, place)
    return distribute_tensor(x, _CTX.mesh, place)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def param_specs(axes_tree, mesh, rules: Optional[AxisRules] = None):
    """Map a logical-axes tree (dicts and lists whose leaves are tuples of
    logical names) to a tree of DTensor placements on ``mesh``."""
    rules = with_rules(rules)

    def walk(node):
        if _is_axes(node):
            return _placements(_resolve(node, rules, mesh), mesh)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        raise TypeError(f"param_specs: unexpected leaf {node!r}")

    return walk(axes_tree)
