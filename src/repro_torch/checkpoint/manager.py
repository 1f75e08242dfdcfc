"""Checkpoints in the reference's on-disk format.

Port of ``repro/checkpoint/manager.py``: one directory a step,
``step_%010d/`` holding ``state.npz`` (the tree flattened to ``a/0/b`` key
paths: dict keys by name, list entries by index, NamedTuple fields by name,
as the reference's ``_flatten`` names them; bf16 leaves widened to float32,
as npz has no bf16) and ``manifest.json``.  A save writes
``step_%010d.tmp`` and renames it, so a crashed save never corrupts the
latest checkpoint (a left-over ``.tmp`` is removed by the next manager on
the directory), and keeps the newest ``keep`` steps.  With ``async_save``
the copy to the host is synchronous (a consistent snapshot) and a
background thread serialises it; :meth:`CheckpointManager.wait` blocks
until the queued saves land and re-raises their errors, and
:meth:`CheckpointManager.close` stops the thread.

An LM ``TrainState(params, opt_state, step)`` of tensors saves under the
reference's keys (``params/...``, ``opt_state/step``, ``opt_state/mu/...``,
``opt_state/nu/...``, ``step``), and ``restore(step, state)`` gives it back
as tensors of the given state's dtypes and devices, so a state saved by
either package restores in the other bit for bit.

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
import queue
import shutil
import threading
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
    """(path, leaf) pairs of a nested dict/list/NamedTuple tree, dict keys
    sorted (the reference's flattening order), NamedTuple fields by name."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array: tensors copied to the host, bf16 widened to
    float32 (exactly, as the reference widens its bf16 leaves)."""
    import torch
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {"/".join(path): _host(leaf) for path, leaf in _leaves(tree)}


def _as_tree(params):
    """A policy module as the reference's tree; a tree as it is."""
    from torch import nn
    if isinstance(params, nn.Module):
        from .convert import params_to_numpy
        return params_to_numpy(params)
    return params


def _unflatten(tree_like, flat: Dict[str, np.ndarray]):
    """``tree_like``'s structure with the leaves of ``flat``, each cast to
    the dtype of the leaf it replaces (a tensor leaf gives a tensor of its
    dtype on its device)."""
    import torch

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, path + (k,))
                                for k, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        shape = tuple(node.shape) if isinstance(node, torch.Tensor) \
            else np.shape(node)
        if arr.shape != shape:
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{arr.shape}, not {shape}")
        if isinstance(node, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(
                dtype=node.dtype, device=node.device)
        return arr.astype(np.asarray(node).dtype)
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
    """Atomic, keep-``keep`` checkpoints of trees (numpy or tensor leaves)
    under ``directory``; ``async_save`` serialises in a background
    thread."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        for name in os.listdir(directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)
        self._q: "queue.Queue" = queue.Queue()
        self._errors: List[BaseException] = []
        self._worker: Optional[threading.Thread] = None
        if async_save:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._write(*item)
            except BaseException as e:   # surfaced by the next wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               meta: Dict) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(_jsonable({"step": step, "time": time.time(),
                                 **meta}), f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

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
        """Save ``tree`` as step ``step``.  The copy to the host happens
        now; with ``async_save`` the file is written in the background."""
        flat = _flatten(tree)
        if self.async_save:
            if self._worker is None:
                raise RuntimeError("CheckpointManager is closed")
            self._q.put((step, flat, dict(meta or {})))
        else:
            self._write(step, flat, meta or {})

    def restore(self, step: int, tree_like: Any = None) -> Any:
        """The tree saved at ``step`` (numpy leaves); with ``tree_like``, in
        its structure, dtypes and (for tensor leaves) devices (a missing
        leaf raises ``KeyError``)."""
        with np.load(os.path.join(self._step_dir(step), "state.npz")) as d:
            flat = {k: d[k] for k in d.files}
        if tree_like is None:
            return _nest(flat)
        return _unflatten(tree_like, flat)

    def manifest(self, step: int) -> Dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def wait(self) -> None:
        """Block until queued saves land; re-raise a failed save's error."""
        if self.async_save:
            self._q.join()
        if self._errors:
            raise self._errors.pop()

    def close(self) -> None:
        """Stop the background thread after the queued saves (no-op for a
        synchronous manager)."""
        if self._worker is not None:
            self._q.put(None)
            self._worker.join()
            self._worker = None

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
