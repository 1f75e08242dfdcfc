"""Carry weights across from the reference package.

The reference keeps its parameters as a nested tree of arrays,
``{"enc": {"trans": [{"w", "b"}, ...], "gnn": [{"w"}, ...]},
"gpn": {"phi": [...]}, "pol": {"mlp": [...]}}`` (a GraphSAGE encoder's
``gnn`` layers hold ``{"w_self", "w_nbr"}``; the device head's ``pol`` is
``{"mlp": [...], "dev": [...]}``), with every weight stored
(in, out) and applied as ``x @ w``.  ``nn.Linear`` stores the transpose.
This module maps between the two; ``checkpoint/manager.py`` reads and
writes the reference's checkpoint format.

The learned baselines' trees map the same way: Placeto's
``{"enc": ..., "head": [...]}`` and the RNN's ``{"enc": {"wx", "wh", "b"},
"dec": {...}, "attn": [...], "head": [...]}`` (``placeto_from_numpy``,
``rnn_from_numpy``; ``params_to_numpy`` reads any of these modules back).

The LM's parameters keep the reference's tree and layouts in the port, so
``lm_params_from_numpy`` copies them leaf for leaf (a reference
``QTensor`` leaf of ``quantize_params``, int8 data and f32 scales, as the
port's ``QTensor``), and
``lm_train_state_from_numpy`` carries a whole training state across: the
parameters, the optimizer's ``OptState(step, mu, nu)`` (the moments in
their own dtype, which may differ from the parameters') and the step, so a
reference run continues in the port from the same next step.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.hsdag import HSDAGPolicy

__all__ = ["params_from_numpy", "params_to_numpy", "tree_from_tensors",
           "tensors_from_tree", "load_reference_policy",
           "placeto_from_numpy", "rnn_from_numpy", "lm_params_from_numpy",
           "lm_train_state_from_numpy"]


def _ref_path(name: str) -> Tuple[Tuple, bool]:
    """``enc.trans.0.weight`` → ((``enc``, ``trans``, 0, ``w``), transposed);
    ``enc.gnn.0.w_self`` → ((``enc``, ``gnn``, 0, ``w_self``), transposed)."""
    parts = name.split(".")
    leaf = {"weight": "w", "bias": "b"}.get(parts[-1], parts[-1])
    path = tuple(int(p) if p.isdigit() else p for p in parts[:-1]) + (leaf,)
    return path, leaf != "b"


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


def tensors_from_tree(names: Iterable[str], tree: Dict) -> List[np.ndarray]:
    """The inverse of :func:`tree_from_tensors`: one float32 array a port
    parameter name, in the port's layout, read from a reference-layout
    tree (a missing or mis-shaped leaf raises)."""
    out = []
    for name in names:
        path, transposed = _ref_path(name)
        arr = np.asarray(_get(tree, path), np.float32)
        out.append(np.ascontiguousarray(arr.T if transposed else arr))
    return out


def _lists(node):
    """Turn dicts keyed 0..n-1 into lists, as the reference tree has them."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def params_to_numpy(policy: torch.nn.Module) -> Dict:
    """A policy's (or a learned baseline's) parameters as a
    reference-layout tree."""
    names, tensors = zip(*policy.named_parameters())
    return tree_from_tensors(names, tensors)


def params_from_numpy(tree: Dict) -> HSDAGPolicy:
    """A CPU ``HSDAGPolicy`` holding the reference tree's values; sizes are
    read off the tree."""
    enc, gpn, pol = tree["enc"], tree["gpn"], tree["pol"]
    # The layer keys name the model, as the reference's encoder reads them.
    sage = bool(enc["gnn"]) and "w" not in enc["gnn"][0]
    device = "dev" in pol
    d_in, hidden = np.shape(enc["trans"][0]["w"])
    policy = HSDAGPolicy(
        d_in, hidden, np.shape(pol["mlp"][-1]["w"])[1],
        layer_trans=len(enc["trans"]), layer_gnn=len(enc["gnn"]),
        gnn_model="sage" if sage else "gcn",
        layer_parsingnet=len(gpn["phi"]), policy_layers=len(pol["mlp"]),
        head="device" if device else "dense",
        dev_feat_dim=np.shape(pol["dev"][0]["w"])[0] if device else None)
    return _fill(policy, tree)


def _fill(module: torch.nn.Module, tree: Dict) -> torch.nn.Module:
    """Copy the reference tree's leaves into ``module``'s parameters (a
    missing or mis-shaped leaf raises)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            path, transposed = _ref_path(name)
            arr = np.asarray(_get(tree, path), np.float32)
            if transposed:
                arr = arr.T
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{arr.shape} does not fit {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr.copy()))
    return module


def placeto_from_numpy(tree: Dict):
    """A CPU ``PlacetoModel`` holding the reference Placeto tree's values;
    sizes are read off the tree."""
    from ..core.baselines import PlacetoModel
    d_in, hidden = np.shape(tree["enc"]["trans"][0]["w"])
    return _fill(PlacetoModel(d_in, hidden,
                              np.shape(tree["head"][-1]["w"])[1]), tree)


def rnn_from_numpy(tree: Dict):
    """A CPU ``RNNModel`` holding the reference RNN tree's values; sizes
    are read off the tree."""
    from ..core.baselines import RNNModel
    d_in, gates = np.shape(tree["enc"]["wx"])
    return _fill(RNNModel(d_in, gates // 4,
                          np.shape(tree["head"][-1]["w"])[1]), tree)


def load_reference_policy(directory: str,
                          step: Optional[int] = None) -> Tuple[Dict, Dict]:
    """Read a ``save_policy`` checkpoint of either package → (tree,
    manifest); ``step=None`` takes the latest complete step."""
    from .manager import restore_policy
    tree, _, _, manifest = restore_policy(directory, step=step)
    return tree, manifest


def _leaf_tensor(a, path: str) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of the same bits.  bf16 arrays (the
    ml_dtypes type JAX hands out) go across as their 16-bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype not in (np.float32, np.int32, np.int8):
        raise ValueError(f"{path}: unsupported leaf dtype {a.dtype}")
    return torch.from_numpy(a.copy())


def _lm_tree_from_numpy(tree: Dict, cfg, device, keep_dtype: bool) -> Dict:
    """``tree`` (numpy leaves) in the structure of ``model_defs(cfg)`` as
    tensors on ``device``; each leaf at its def's shape and, unless
    ``keep_dtype``, its dtype."""
    from ..models.lm import model_defs
    from ..models.params import ParamDef
    from ..models.quantize import QTensor
    device = torch.device(device)

    def quantized(defs, node, where):
        """A reference ``QTensor(data, scale)`` for ``defs``."""
        shape = defs.shape
        scale_shape = (shape[0], shape[-1]) if len(shape) >= 3 \
            else (shape[-1],)
        data = _leaf_tensor(node.data, f"{where}/data")
        scale = _leaf_tensor(node.scale, f"{where}/scale")
        if data.dtype != torch.int8 or tuple(data.shape) != shape \
                or scale.dtype != torch.float32 \
                or tuple(scale.shape) != scale_shape:
            raise ValueError(
                f"{where}: a quantized leaf must be int8 data {shape} and "
                f"float32 scales {scale_shape}; got {data.dtype} "
                f"{tuple(data.shape)} and {scale.dtype} "
                f"{tuple(scale.shape)}")
        return QTensor(data.to(device), scale.to(device))

    def walk(defs, node, path):
        where = "/".join(map(str, path)) or "<root>"
        if isinstance(defs, ParamDef):
            if isinstance(node, tuple) and getattr(node, "_fields", ()) \
                    == ("data", "scale"):
                return quantized(defs, node, where)
            if isinstance(node, (dict, list, tuple)) or node is None:
                raise ValueError(f"{where}: expected an array leaf")
            t = _leaf_tensor(node, where)
            if tuple(t.shape) != defs.shape or (
                    not keep_dtype and t.dtype != defs.dtype):
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


def lm_params_from_numpy(tree: Dict, cfg, device="cuda") -> Dict:
    """The reference LM's ``init_params`` tree (numpy leaves) as the port's
    params for ``cfg`` on ``device``; a tree of the reference's
    ``quantize_params`` carries its ``QTensor`` leaves (int8 data at the
    leaf's shape, f32 scales) across as the port's ``QTensor``.

    Every leaf of the port's ``model_defs(cfg)`` must be in ``tree`` with the
    same shape and dtype, and ``tree`` may hold nothing else: a missing,
    extra or mis-shaped leaf raises ``ValueError``.
    """
    return _lm_tree_from_numpy(tree, cfg, device, keep_dtype=False)


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def lm_train_state_from_numpy(state, cfg, device="cuda"):
    """The reference's ``TrainState(params, opt_state, step)`` with numpy
    leaves (``jax.tree.map(np.asarray, state)``, or a dict of those three
    keys) as the port's ``TrainState`` on ``device``: params as
    ``lm_params_from_numpy``, ``OptState(step, mu, nu)`` with the moments at
    the parameters' shapes in their own dtypes, the steps as int32 CPU
    tensors."""
    from ..models.lm import TrainState
    from ..optim import OptState
    opt = _field(state, "opt_state")

    def step_of(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32)

    return TrainState(
        lm_params_from_numpy(_field(state, "params"), cfg, device),
        OptState(step_of(_field(opt, "step")),
                 _lm_tree_from_numpy(_field(opt, "mu"), cfg, device, True),
                 _lm_tree_from_numpy(_field(opt, "nu"), cfg, device, True)),
        step_of(_field(state, "step")))
