"""AotExecutableCache — the persistent per-bucket decode cache, PyTorch port.

Port of ``repro/api/aot.py``.  The file store is the reference's: one blob
a ``(spec_hash, bucket shape, batch_slots)`` key under
``<dir>/<spec_hash>/greedy_v1_<v>v<e>e<g>g.ptaot``, written atomically
(temp file + ``os.replace``), a missing blob a miss and an empty one a miss
and a load failure.  The suffix is the port's own, so a reference blob
(``.jaxaot``) and a port blob in one directory never read each other.

What a blob holds differs.  The reference serialises the bucket's traced
greedy decode (``jax.export``), and a fresh process that loads it skips
the trace and XLA compile (~1.1 s a bucket).  The port traces and compiles
nothing per shape: its decode is eager PyTorch plus the hand-written
kernels, whose only build is the hashed ``.so`` libraries of
``kernels/_build.py``, made once per build under ``build/repro_torch/``.
So the port's blob (:func:`greedy_blob`) is a small JSON document that
records what a fresh process must check and load before it decodes that
bucket: torch's version and CUDA version, the device's kind and compute
capability, the key, and the file names (source hashes included) of the
kernel libraries the decode launches.  :func:`preload_greedy` checks every
field against the running process and loads those libraries without
building; it raises on any mismatch or missing library, and the service
counts that as a load failure and stores a fresh blob.

This cache saves a fresh process the library checks and loads, not a
compile.  Whether that is measurable on the card is recorded in PERF.md
(``tools/port_aot_first_request.py``).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

from ..kernels import _build

__all__ = ["AotExecutableCache", "greedy_blob", "preload_greedy",
           "DECODE_KERNELS"]

_FORMAT = "v1"  # bump to orphan old blobs if the on-disk layout changes
_SUFFIX = ".ptaot"
_BLOB_FORMAT = "repro_torch.greedy_decode.v1"

#: kernel libraries a greedy decode launches on the card: the encoder's
#: ``gcn_aggregate`` and ``sage_aggregate`` (both ``csrc/gcn_spmm.cu``)
DECODE_KERNELS = ("gcn_spmm",)


class AotExecutableCache:
    """See module docstring.  Example::

        cache = AotExecutableCache("ckpt/aot")
        service = PlacementService(session, aot_cache=cache)
        # ... serve ...; a later process with the same cache dir decodes
        # every bucket served here with no cold bucket.
    """

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.load_failures = 0

    # ------------------------------------------------------------ key layout
    def _path(self, spec_hash: str, bucket_shape: Tuple[int, int],
              batch_slots: int) -> str:
        v, e = (int(x) for x in bucket_shape)
        fname = f"greedy_{_FORMAT}_{v}v{e}e{int(batch_slots)}g{_SUFFIX}"
        return os.path.join(self.directory, str(spec_hash), fname)

    # -------------------------------------------------------------- load/store
    def load(self, spec_hash: str, bucket_shape: Tuple[int, int],
             batch_slots: int) -> Optional[bytes]:
        """→ the stored blob, or ``None`` (counted as a miss).

        An empty blob (a torn write's survivor) counts as both a miss and a
        ``load_failure``: the caller decodes cold and overwrites it.
        """
        path = self._path(spec_hash, bucket_shape, batch_slots)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            self.misses += 1
            return None
        if not blob:
            self.misses += 1
            self.load_failures += 1
            return None
        self.hits += 1
        return blob

    def store(self, spec_hash: str, bucket_shape: Tuple[int, int],
              batch_slots: int, blob: bytes) -> str:
        """Atomically persist ``blob``; → the written path."""
        path = self._path(spec_hash, bucket_shape, batch_slots)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.stores += 1
        return path

    def note_load_failure(self) -> None:
        """Record that a loaded blob failed its checks downstream."""
        self.load_failures += 1

    # --------------------------------------------------------------- queries
    def entries(self, spec_hash: Optional[str] = None) -> List[str]:
        """Relative paths of every persisted blob (one tenant's with
        ``spec_hash``)."""
        roots = [spec_hash] if spec_hash is not None else sorted(
            d for d in os.listdir(self.directory)
            if os.path.isdir(os.path.join(self.directory, d)))
        out: List[str] = []
        for root in roots:
            tenant_dir = os.path.join(self.directory, root)
            if not os.path.isdir(tenant_dir):
                continue
            out.extend(os.path.join(root, f)
                       for f in sorted(os.listdir(tenant_dir))
                       if f.endswith(_SUFFIX))
        return out

    def clear(self, spec_hash: str) -> int:
        """Drop one tenant's blobs; → number removed."""
        removed = 0
        tenant_dir = os.path.join(self.directory, str(spec_hash))
        if not os.path.isdir(tenant_dir):
            return 0
        for f in os.listdir(tenant_dir):
            if f.endswith(_SUFFIX):
                os.unlink(os.path.join(tenant_dir, f))
                removed += 1
        return removed

    def stats(self) -> Dict[str, int]:
        return {"aot_hits": self.hits, "aot_misses": self.misses,
                "aot_stores": self.stores,
                "aot_load_failures": self.load_failures,
                "aot_entries": len(self.entries())}


# ------------------------------------------------------------- the port's blob
def _blob_doc(spec_hash: str, bucket_shape: Tuple[int, int],
              batch_slots: int, device: torch.device) -> Dict:
    """The blob document this process would write for the key."""
    device = torch.device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        capability = list(torch.cuda.get_device_capability(device))
        libraries = {name: _build._lib_path(name).name
                     for name in DECODE_KERNELS}
    else:               # the plain versions: no kernel library is launched
        kind, capability, libraries = "cpu", None, {}
    return {"format": _BLOB_FORMAT, "torch": torch.__version__,
            "cuda": torch.version.cuda, "device": kind,
            "capability": capability, "spec_hash": str(spec_hash),
            "bucket": [int(x) for x in bucket_shape],
            "batch_slots": int(batch_slots), "libraries": libraries}


def greedy_blob(spec_hash: str, bucket_shape: Tuple[int, int],
                batch_slots: int, device) -> bytes:
    """The blob for one bucket's greedy decode on ``device`` (JSON)."""
    return json.dumps(_blob_doc(spec_hash, bucket_shape, batch_slots,
                                device), sort_keys=True).encode()


def preload_greedy(blob: bytes, spec_hash: str,
                   bucket_shape: Tuple[int, int], batch_slots: int,
                   device) -> None:
    """Check ``blob`` against this process and load the kernel libraries
    it names, without building.

    Raises ``ValueError`` when the blob is not a port blob or any field
    differs from what this process would write (torch or CUDA version,
    device kind or capability, key, a library's source hash), and
    ``FileNotFoundError`` when a named library is not built.
    """
    try:
        doc = json.loads(bytes(blob).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"not a repro_torch AOT blob: {e}") from None
    if not isinstance(doc, dict):
        raise ValueError("not a repro_torch AOT blob: not a JSON object")
    want = _blob_doc(spec_hash, bucket_shape, batch_slots, device)
    differ = sorted(k for k in set(want) | set(doc)
                    if doc.get(k) != want.get(k))
    if differ:
        raise ValueError(
            "AOT blob does not match this process: " + "; ".join(
                f"{k} {doc.get(k)!r} != {want.get(k)!r}" for k in differ))
    for name in doc["libraries"]:
        _build.library(name, build=False)
