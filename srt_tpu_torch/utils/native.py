"""ctypes binding of the port's host runtime (``csrc/srt_native.cpp``):
the C++ BVH builder.

Counterpart of ``srt_tpu/utils/native.py`` without its OBJ loader
(``load_object`` keeps the Python parser; ROADMAP.md, queue A).  The
library is built at first use with the host C++ compiler (``g++``, else
``c++``) into ``build/srt_tpu_torch/`` under the repository root (ignored
by git), named by a digest of the source and flags, and reused while they
hash the same.  It is host code only: neither the nvcc kernel library of
``ops/cuda_lib.py`` nor a card is involved.

``available()`` is False only when no C++ compiler is on ``PATH`` or
``SRT_NO_NATIVE`` is set (to any non-empty value, read at each call);
``build_bvh_native`` then returns None and ``build_bvh`` takes the numpy
builder.  With a compiler present, a failed build or load raises: nothing
falls back in silence.  The trees equal the numpy builder's array for
array (``tests/test_torch_native.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from srt_tpu_torch.utils.bvh import FlatBVH

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "srt_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srt_tpu_torch"
# The JAX package's native/Makefile flags.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_F = ctypes.POINTER(ctypes.c_float)
_U = ctypes.POINTER(ctypes.c_uint32)
_I64 = ctypes.c_int64


def _compiler() -> Optional[str]:
    return shutil.which("g++") or shutil.which("c++")


def available() -> bool:
    """Whether the C++ builder runs: a C++ compiler on ``PATH`` and no
    ``SRT_NO_NATIVE``."""
    return not os.environ.get("SRT_NO_NATIVE") and _compiler() is not None


def _build(cxx: str, so: Path) -> None:
    """Compile the source into ``so`` through a per-process temporary file,
    so that processes building at once never load a partial library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
    try:
        run = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({run.returncode}) on "
                               f"{SOURCE.name}:\n{run.stdout}{run.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on failure."""
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"libsrt_native_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _build(cxx, so)
    lib = ctypes.CDLL(str(so))
    lib.srt_bvh_build.restype = _I64
    lib.srt_bvh_build.argtypes = [_F, _F, _F, _I64, _I64, _F, _F, _U, _U, _U]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F)


def _uptr(a: np.ndarray):
    return a.ctypes.data_as(_U)


def build_bvh_native(centers: np.ndarray, bounds_min: np.ndarray,
                     bounds_max: np.ndarray,
                     leaf_size: int = 2) -> Optional[FlatBVH]:
    """Native BVH build -> FlatBVH, the numpy builder's tree, or None when
    ``available()`` is False."""
    if not available():
        return None
    n = centers.shape[0]
    centers = np.ascontiguousarray(centers, np.float32)
    bmin = np.ascontiguousarray(bounds_min, np.float32)
    bmax = np.ascontiguousarray(bounds_max, np.float32)
    if not centers.shape == bmin.shape == bmax.shape == (n, 3):
        raise ValueError(f"centers, bounds_min and bounds_max must be [T, 3]"
                         f": {centers.shape}, {bmin.shape}, {bmax.shape}")
    lib = load()
    cap = max(1, 2 * n - 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_first = np.zeros(cap, np.uint32)
    node_count = np.zeros(cap, np.uint32)
    order = np.empty(n, np.uint32)
    used = lib.srt_bvh_build(
        _fptr(centers), _fptr(bmin), _fptr(bmax), n, leaf_size,
        _fptr(node_min), _fptr(node_max), _uptr(node_first),
        _uptr(node_count), _uptr(order))
    return FlatBVH(
        node_min=node_min[:used].copy(),
        node_max=node_max[:used].copy(),
        node_first=node_first[:used].copy(),
        node_count=node_count[:used].copy(),
        prim_order=order)
