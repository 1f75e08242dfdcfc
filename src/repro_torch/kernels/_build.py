"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own into
a shared library for ``sm_90a`` (Hopper).  Nothing is built at import: the
first kernel launch builds every source that is not built yet, one ``nvcc``
process per source, all started together.  Libraries are named by a hash of
their source, the ``csrc/*.cuh`` headers it includes and their flags, so an
edited source or header is rebuilt and a stale library is never loaded.

The build directory is ``build/repro_torch`` at the root of the checkout
(the package runs from a checkout: ``csrc/`` is not installed data).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["build_all", "library", "build_dir", "SOURCES"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"

# --fmad=false: a kernel rounds like its plain PyTorch version, which
# multiplies and adds in separate steps.
_EXACT = ("--fmad=false",)

#: kernel library name → (its source under ``csrc/``, its own nvcc flags).
#: The attention kernels (forward and backward, bf16 and f32) run on the
#: tensor cores, whose products round in their own order, so they keep
#: fused multiply-adds; they take cuTensorMapEncodeTiled from libcuda
#: through the CUDA runtime, so they link nothing beyond the runtime either.
SOURCES = {"levelsim": ("levelsim.cu", _EXACT),
           "gcn_spmm": ("gcn_spmm.cu", _EXACT),
           "rmsnorm": ("rmsnorm.cu", _EXACT),
           "flash_attention_sm90": ("flash_attention_sm90.cu", ()),
           "flash_attention_tf32_sm90": ("flash_attention_tf32_sm90.cu", ()),
           "flash_attention_bwd_sm90": ("flash_attention_bwd_sm90.cu", ()),
           "flash_attention_bwd_tf32_sm90": (
               "flash_attention_bwd_tf32_sm90.cu", ()),
           "ssd_scan": ("ssd_scan.cu", _EXACT)}

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _flags(name: str):
    return (*_FLAGS, *SOURCES[name][1])


_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit on PATH or under "
                       "/usr/local/cuda)")


def _headers(src: bytes) -> List[str]:
    """The ``csrc/*.cuh`` headers a source includes by a quoted name."""
    return sorted({m.decode() for m in
                   re.findall(rb'#include\s+"([\w.]+\.cuh)"', src)})


def _lib_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name][0]).read_bytes()
    h = hashlib.sha256(src)
    for header in _headers(src):
        h.update(header.encode() + (_CSRC / header).read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every kernel library not built yet; → wall seconds per source.

    One ``nvcc`` per source, all running at once.  ``nvcc``'s output (the
    ``-Xptxas -v`` register and shared-memory report) is kept beside each
    library as ``<lib>.log``.  Raises with that output when a build fails.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = {name: _lib_path(name) for name in SOURCES
            if not _lib_path(name).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        proc = subprocess.Popen(
            [nvcc, *_flags(name), "-o", str(tmp),
             str(_CSRC / SOURCES[name][0])],
            stdout=log, stderr=subprocess.STDOUT)
        procs[name] = (proc, tmp, path, log)
    seconds: Dict[str, float] = {}
    failed = []
    for name, (proc, tmp, path, log) in procs.items():
        try:
            rc = proc.wait()
        finally:
            log.close()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, path)
        else:
            failed.append((name, path.with_suffix(".log").read_text()))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {name} ---\n{text}" for name, text in failed))
    return seconds


def library(name: str, *, build: bool = True) -> ctypes.CDLL:
    """The loaded kernel library ``name``: built on first use, or with
    ``build=False`` loaded only if already built (else FileNotFoundError)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if build:
                build_all()
            elif not path.exists():
                raise FileNotFoundError(f"kernel library {name!r} is not "
                                        f"built: no {path}")
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
