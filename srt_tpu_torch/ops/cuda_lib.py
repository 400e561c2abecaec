"""Build and load the hand-written CUDA kernels of ``srt_tpu_torch/csrc``.

The sources compile with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together, and link into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, into ``build/srt_tpu_torch/`` under the repository root
(ignored by git), and is reused while the sources and flags hash the same.
Nothing here runs at import time.

``launch`` calls one C entry point on PyTorch's current stream, raises if
the launch failed and adds one to ``launch_counts[name]``: the kernel
wrappers (``ops/traversal.py``, ``ops/rng.py``,
``tools/micro_occ.py``) count only real kernel
launches this way, never a plain-version call.  ``launch_counts`` also
holds ``BRANCH_COUNTERS``, which ``traversal.model_hit`` advances itself.
Every kernel pays ``launch``'s host cost on every call, so it does the
least it can: the entry points are resolved once, by ``load``; the
stream is read as a raw pointer, with no ``torch.cuda.Stream`` object;
the device is switched only when the tensors are not on the current one.

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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srt_tpu_torch"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = GENCODE + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas",
    "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_WALK_B2 = [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]
_WALK_B4 = [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P]
# C entry points: name -> argument types (the trailing stream included).
SIGNATURES = {
    "srt_cull": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "srt_intersect": _WALK_B2 + [_P],
    "srt_intersect_stream": _WALK_B2 + [_P],
    "srt_intersect_count": _WALK_B2 + [_P, _P],
    "srt_cull_pg2": [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P],
    "srt_pgwalk2": _WALK_B4 + [_P],
    "srt_pgwalk2_stream": _WALK_B4 + [_P],
    "srt_threefry": [_P, _P, _I, _U, _I, _U, _I, _P, _P],
    "srt_cull_perray": [_P, _P, _I, _I, _I, _I, _P, _P],
    "srt_cull_gmask": [_P, _P, _I, _P, _I, _I, _I, _I, _P, _P],
    "srt_pgwalk": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                   _P],
    "srt_add_one": [_P, _P, _I, _P],
    "srt_occupancy_cf": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
}
# Branch counters of ``traversal.model_hit``'s pair-binned walk: calls
# that took the pair tiles, calls that fell back to the tiled walk.  They
# count a decision, on any device, not a kernel launch.
BRANCH_COUNTERS = ("binned_pairs", "binned_fallback")

# Kernel launches on CUDA tensors, by wrapper name (``srt_<name>``), and
# the branch counters.
launch_counts = {name[4:]: 0 for name in SIGNATURES}
launch_counts.update({name: 0 for name in BRANCH_COUNTERS})


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an up-to-date build was reused
    log: str               # nvcc's output (ptxas register/spill lines)
    # Wrapper name (a ``launch_counts`` key) -> its C entry point.
    functions: dict


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


def _run(procs) -> str:
    """Wait for every process; return their output, or raise with it if
    any failed."""
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{p.args[0]} failed ({p.returncode}):\n{out}")
    return log


def _build(sources, so: Path) -> str:
    """Compile each source in its own nvcc process, all at once, then link
    the objects into ``so``; returns nvcc's output."""
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp / f"{src.stem}.o" for src in sources]
        log = _run([subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)])
        lib = tmp / so.name
        log += _run([subprocess.Popen(
            [nvcc, *GENCODE, "-shared", "-o", str(lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)])
        os.replace(lib, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return log


@functools.lru_cache(maxsize=None)
def load() -> Library:
    """Build (if needed) and load the kernel library; raises on failure."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = _digest(sorted(CSRC.glob("*.cu*")))
    so = BUILD_DIR / f"libsrt_tpu_torch_{digest}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        t0 = time.perf_counter()
        log = _build(sources, so)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    functions = {}
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        functions[name[4:]] = fn
    lib.srt_error_string.argtypes = [ctypes.c_int]
    lib.srt_error_string.restype = ctypes.c_char_p
    return Library(lib=lib, path=so, build_seconds=seconds, log=log,
                   functions=functions)


def error_string(code: int) -> str:
    return f"{load().lib.srt_error_string(code).decode()} ({code})"


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _current_device() -> int:
    return torch._C._cuda_getDevice()


def _raw_stream(index: int) -> int:
    """The current stream of device ``index`` as a pointer, read as
    PyTorch's own generated launchers read it, without building a
    ``torch.cuda.Stream``; a launch inside a CUDA-graph capture is
    captured, as on the stream object."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, *args) -> None:
    """Call ``srt_<name>`` on the current stream of the device of its first
    argument, a tensor, and raise if the launch failed.  Tensors go as
    pointers, None as a null pointer, ints as the signature's C type."""
    fn = load().functions[name]
    index = args[0].get_device()
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    stream = _raw_stream(index)
    if index == _current_device():
        err = fn(*cargs, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"kernel {name} failed to launch: "
                           f"{error_string(err)}")
    launch_counts[name] += 1
