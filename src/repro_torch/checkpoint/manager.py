"""Checkpoints in the reference's on-disk format.

Port of ``repro/checkpoint/manager.py``: one directory a step,
``step_%010d/`` holding ``state.npz`` (the parameter tree flattened to
``a/0/b`` key paths: dict keys by name, list entries by index) and
``manifest.json``.  A save writes ``step_%010d.tmp`` and renames it, so a
crashed save never corrupts the latest checkpoint (a left-over ``.tmp`` is
removed by the next manager on the directory), and keeps the newest
``keep`` steps.  Saves are synchronous: the reference's background-thread
saves (``async_save``) are not ported, and :meth:`CheckpointManager.wait`
and :meth:`CheckpointManager.close` have nothing to wait for.

A corpus run's checkpoint (``CurriculumTrainer``) holds ``{"params",
"opt"}``, the optimizer state as the reference's ``OptState`` tree
(``opt/step``, ``opt/mu/...``, ``opt/nu/...``), and its manifest the
episode, corpus fingerprint, sampler, tracker, population, EMA baseline,
mesh and stream records under the reference's keys, so either package
resumes the other's run.

A policy is saved as the reference's parameter tree
(``checkpoint.convert.params_to_numpy``), so the reference's
``restore_policy`` reads the port's checkpoints and the port's reads the
reference's.  No ``torch.save`` pickle is written.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["CheckpointManager", "save_policy", "restore_policy",
           "policy_manifest", "policy_feature_config"]


def _jsonable(obj):
    """Manifest sanitizer: numpy scalars/arrays → plain Python."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _jsonable(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict/list tree, dict keys sorted (the
    reference's flattening order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {"/".join(path): np.asarray(leaf) for path, leaf in _leaves(tree)}


def _as_tree(params):
    """A policy module as the reference's tree; a tree as it is."""
    from torch import nn
    if isinstance(params, nn.Module):
        from .convert import params_to_numpy
        return params_to_numpy(params)
    return params


def _unflatten(tree_like, flat: Dict[str, np.ndarray]):
    """``tree_like``'s structure with the leaves of ``flat``, each cast to
    the dtype of the leaf it replaces."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr, like = flat[key], np.asarray(node)
        if arr.shape != like.shape:
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{arr.shape}, not {like.shape}")
        return arr.astype(like.dtype)
    return walk(tree_like, ())


def _nest(flat: Dict[str, np.ndarray]):
    """The nested tree of ``a/0/b`` keys (integer keys become lists)."""
    from .convert import _lists
    tree: Dict = {}
    for key, arr in flat.items():
        path = [int(p) if p.isdigit() else p for p in key.split("/")]
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return _lists(tree)


class CheckpointManager:
    """Atomic, keep-``keep`` checkpoints of numpy trees under
    ``directory``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        for name in os.listdir(directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    steps.append(int(name[5:]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"), **_flatten(tree))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(_jsonable({"step": step, "time": time.time(),
                                 **(meta or {})}), f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore(self, step: int, tree_like: Any = None) -> Any:
        """The tree saved at ``step`` (numpy leaves); with ``tree_like``, in
        its structure and dtypes (a missing leaf raises ``KeyError``)."""
        with np.load(os.path.join(self._step_dir(step), "state.npz")) as d:
            flat = {k: d[k] for k in d.files}
        if tree_like is None:
            return _nest(flat)
        return _unflatten(tree_like, flat)

    def manifest(self, step: int) -> Dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def wait(self) -> None:
        """No-op: saves are synchronous (the reference's waits for its
        background saves)."""

    def close(self) -> None:
        """No-op: no background worker to stop."""

    def _step_or_latest(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under "
                                    f"{self.directory!r}")
        return step


# --------------------------------------------------------------------------
# Shared-policy checkpoints: the feature layout rides along in the manifest,
# since a policy is only usable on a graph featurized with the vocabularies
# it was trained on.
# --------------------------------------------------------------------------


def _feature_config_to_meta(feature_config) -> Optional[Dict]:
    if feature_config is None:
        return None
    d = dataclasses.asdict(feature_config)
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}


def _feature_config_from_meta(meta: Optional[Dict]):
    if not meta:
        return None
    from ..core.features import FeatureConfig
    kw = dict(meta)
    for key in ("op_vocab", "in_deg_vocab", "out_deg_vocab"):
        if kw.get(key) is not None:
            kw[key] = tuple(kw[key])
    return FeatureConfig(**kw)


def save_policy(directory: str, params: Any, *, step: int = 0,
                feature_config=None, meta: Optional[Dict] = None,
                keep: int = 3) -> None:
    """Atomically save a policy (an ``HSDAGPolicy`` or the reference's
    tree) and its feature layout."""
    full_meta = dict(meta or {})
    fc = _feature_config_to_meta(feature_config)
    if fc is not None:
        full_meta["feature_config"] = fc
    CheckpointManager(directory, keep=keep).save(step, _as_tree(params),
                                                 full_meta)


def policy_manifest(directory: str, step: Optional[int] = None) -> Dict:
    """The manifest of a ``save_policy`` checkpoint (training config, the
    engine that produced the rewards, feature layout, ...)."""
    mgr = CheckpointManager(directory)
    return mgr.manifest(mgr._step_or_latest(step))


def policy_feature_config(directory: str, step: Optional[int] = None):
    """The feature layout a ``save_policy`` checkpoint was trained with
    (``None`` when it recorded none), read without a parameter tree."""
    return _feature_config_from_meta(
        policy_manifest(directory, step).get("feature_config"))


def restore_policy(directory: str, params_like: Any = None,
                   step: Optional[int] = None, *, graphs=None):
    """→ (tree, feature_config, step, manifest) from a ``save_policy``
    checkpoint of either package.

    ``tree`` is the reference's parameter tree (numpy leaves;
    ``HSDAG.load_params`` adopts it).  ``params_like`` (an ``HSDAGPolicy``
    or such a tree) fixes its structure: each of its leaves must be in the
    checkpoint, at its shape.  ``graphs`` — the graphs the restored policy
    is about to run on — are checked against the saved vocabularies
    (:func:`~repro_torch.core.features.check_feature_compat`).
    """
    mgr = CheckpointManager(directory)
    step = mgr._step_or_latest(step)
    manifest = mgr.manifest(step)
    feature_config = _feature_config_from_meta(manifest.get("feature_config"))
    if graphs is not None:
        from ..core.features import check_feature_compat
        if feature_config is None:
            raise ValueError(
                f"checkpoint {directory!r} records no feature_config; "
                f"cannot validate it against the given graphs")
        check_feature_compat(feature_config, graphs)
    tree = mgr.restore(step, None if params_like is None
                       else _as_tree(params_like))
    return tree, feature_config, step, manifest
