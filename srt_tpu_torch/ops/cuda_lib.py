"""Build and load the hand-written CUDA kernels of ``srt_tpu_torch/csrc``.

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, into ``build/srt_tpu_torch/`` under the repository root
(ignored by git), and is reused while the sources and flags hash the same.
Nothing here runs at import time.

Flags: ``-fmad=false`` keeps every multiply and add separately rounded, so
a kernel's candidate t equals its plain PyTorch version's bit for bit; no
``--use_fast_math`` (min/max must keep their NaN semantics and division
its IEEE rounding).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srt_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (the trailing stream included).
SIGNATURES = {
    "srt_cull": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "srt_intersect": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "srt_cull_pg2": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "srt_pgwalk2": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P],
}


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an up-to-date build was reused
    log: str               # nvcc's output (ptxas register/spill lines)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load() -> Library:
    """Build (if needed) and load the kernel library; raises on failure."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = _digest(sorted(CSRC.glob("*.cu*")))
    so = BUILD_DIR / f"libsrt_tpu_torch_{digest}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.srt_error_string.argtypes = [ctypes.c_int]
    lib.srt_error_string.restype = ctypes.c_char_p
    return Library(lib=lib, path=so, build_seconds=seconds, log=log)


def error_string(code: int) -> str:
    return f"{load().lib.srt_error_string(code).decode()} ({code})"
