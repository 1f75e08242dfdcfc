"""Carry weights across from the reference package.

The reference keeps its parameters as a nested tree of arrays,
``{"enc": {"trans": [{"w", "b"}, ...], "gnn": [{"w"}, ...]},
"gpn": {"phi": [...]}, "pol": {"mlp": [...]}}``, with every ``w`` stored
(in, out) and applied as ``x @ w``.  ``nn.Linear`` stores the transpose.
This module maps between the two and reads the reference's ``save_policy``
checkpoints (``step_<n>/state.npz`` + ``manifest.json``) with numpy alone.

The LM's parameters keep the reference's tree and layouts in the port, so
``lm_params_from_numpy`` copies them leaf for leaf.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..core.hsdag import HSDAGPolicy

__all__ = ["params_from_numpy", "params_to_numpy", "tree_from_tensors",
           "load_reference_policy", "lm_params_from_numpy"]


def _ref_path(name: str) -> Tuple[Tuple, bool]:
    """``enc.trans.0.weight`` → ((``enc``, ``trans``, 0, ``w``), transposed)."""
    parts = name.split(".")
    leaf = {"weight": "w", "bias": "b"}[parts[-1]]
    path = tuple(int(p) if p.isdigit() else p for p in parts[:-1]) + (leaf,)
    return path, leaf == "w"


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def tree_from_tensors(names: Iterable[str],
                      tensors: Iterable[torch.Tensor]) -> Dict:
    """Reference-layout tree (numpy leaves) from port parameter names and
    tensors of the same shapes (the parameters or their gradients)."""
    tree: Dict = {}
    for name, t in zip(names, tensors):
        path, transposed = _ref_path(name)
        arr = t.detach().cpu().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr.T.copy() if transposed else arr.copy()
    return _lists(tree)


def _lists(node):
    """Turn dicts keyed 0..n-1 into lists, as the reference tree has them."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def params_to_numpy(policy: HSDAGPolicy) -> Dict:
    """The policy's parameters as a reference-layout tree."""
    names, tensors = zip(*policy.named_parameters())
    return tree_from_tensors(names, tensors)


def params_from_numpy(tree: Dict) -> HSDAGPolicy:
    """A CPU ``HSDAGPolicy`` holding the reference tree's values; sizes are
    read off the tree."""
    enc, gpn, pol = tree["enc"], tree["gpn"], tree["pol"]
    if enc["gnn"] and "w" not in enc["gnn"][0]:
        raise NotImplementedError(
            "only gnn_model='gcn' is ported; ROADMAP.md 'Modules to port' "
            "item 4 ports 'sage'")
    if "dev" in pol:
        raise NotImplementedError(
            "only head='dense' is ported; ROADMAP.md 'Modules to port' item "
            "7 ports head='device'")
    d_in, hidden = np.shape(enc["trans"][0]["w"])
    policy = HSDAGPolicy(
        d_in, hidden, np.shape(pol["mlp"][-1]["w"])[1],
        layer_trans=len(enc["trans"]), layer_gnn=len(enc["gnn"]),
        layer_parsingnet=len(gpn["phi"]), policy_layers=len(pol["mlp"]))
    with torch.no_grad():
        for name, p in policy.named_parameters():
            path, transposed = _ref_path(name)
            arr = np.asarray(_get(tree, path), np.float32)
            if transposed:
                arr = arr.T
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{arr.shape} does not fit {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr.copy()))
    return policy


def load_reference_policy(directory: str,
                          step: Optional[int] = None) -> Tuple[Dict, Dict]:
    """Read a reference ``save_policy`` checkpoint → (tree, manifest).

    ``step=None`` takes the latest complete step.
    """
    if step is None:
        steps = sorted(
            int(name[5:]) for name in os.listdir(directory)
            if name.startswith("step_") and not name.endswith(".tmp")
            and os.path.exists(os.path.join(directory, name,
                                            "manifest.json")))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
        step = steps[-1]
    step_dir = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    tree: Dict = {}
    with np.load(os.path.join(step_dir, "state.npz")) as data:
        for key in data.files:
            path = [int(p) if p.isdigit() else p for p in key.split("/")]
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = data[key]
    return _lists(tree), manifest


def _leaf_tensor(a, path: str) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of the same bits.  bf16 arrays (the
    ml_dtypes type JAX hands out) go across as their 16-bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype not in (np.float32, np.int32):
        raise ValueError(f"{path}: unsupported leaf dtype {a.dtype}")
    return torch.from_numpy(a.copy())


def lm_params_from_numpy(tree: Dict, cfg, device="cuda") -> Dict:
    """The reference LM's ``init_params`` tree (numpy leaves) as the port's
    params for ``cfg`` on ``device``.

    Every leaf of the port's ``model_defs(cfg)`` must be in ``tree`` with the
    same shape and dtype, and ``tree`` may hold nothing else: a missing,
    extra or mis-shaped leaf raises ``ValueError``.
    """
    from ..models.lm import model_defs
    from ..models.params import ParamDef
    device = torch.device(device)

    def walk(defs, node, path):
        where = "/".join(map(str, path)) or "<root>"
        if isinstance(defs, ParamDef):
            if isinstance(node, (dict, list, tuple)) or node is None:
                raise ValueError(f"{where}: expected an array leaf")
            t = _leaf_tensor(node, where)
            if tuple(t.shape) != defs.shape or t.dtype != defs.dtype:
                raise ValueError(
                    f"{where}: {t.dtype} {tuple(t.shape)} does not fit "
                    f"{defs.dtype} {defs.shape}")
            return t.to(device)
        if isinstance(defs, dict):
            if not isinstance(node, dict):
                raise ValueError(f"{where}: expected a dict")
            missing = sorted(set(defs) - set(node))
            extra = sorted(set(node) - set(defs))
            if missing or extra:
                raise ValueError(f"{where}: missing leaves {missing}, extra "
                                 f"leaves {extra}")
            return {k: walk(defs[k], node[k], path + (k,)) for k in defs}
        if not isinstance(node, (list, tuple)) or len(node) != len(defs):
            raise ValueError(f"{where}: expected a list of {len(defs)}")
        return [walk(d, n, path + (i,)) for i, (d, n) in
                enumerate(zip(defs, node))]

    return walk(model_defs(cfg), tree, ())
