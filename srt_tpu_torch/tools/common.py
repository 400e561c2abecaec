"""What the measurement tools share: the card's line, timing, the
scenes and cameras of the JAX package's tools, their defaults and flags.

Times: ``wall_s`` is JAX's ``timeit`` (warm-up calls, then ``reps`` calls
back to back, one synchronise at the end; host clock), so it holds the
host's dispatch as well as the card's work.  ``device_ms`` is the card's
own time of one call: the calls are enqueued behind a spin kernel that
outlasts their dispatch and timed between two CUDA events (None on the
CPU, where no device time exists).  ``kernel_times`` brackets each launch
of the named kernels with CUDA events inside a real call.  ``device_ops``
sums one call's device operations in a ``torch.profiler`` trace: for
calls that read the card from the host, or launch more kernels than
calls queued behind a spin could hold.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

from srt_tpu_torch.config import CameraConfig
from srt_tpu_torch.devices import resolve
from srt_tpu_torch.models import mesh, pathtracer
from srt_tpu_torch.utils.flatten import flatten_models
from srt_tpu_torch.utils.procgen import rubik_grid, uv_sphere

HEADLINE_CAMERA = dict(origin=(0.0, 1.0, 5.0), look_at=(0.0, 0.0, 0.0))
RUBIK_CAMERA = dict(origin=(0.0, 20.0, 20.0), look_at=(0.0, 1.0, -1.0))
# The card's yardstick (NVIDIA's H100 SXM data sheet): FP32 outside the
# tensor cores and the memory rate; a Woop evaluation is 52 FP32
# operations (PERF.md, the kernel table's convention).
PEAK_FP32_OPS_S = 67e12
PEAK_BYTES_S = 3.35e12
WOOP_OPS = 52


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def headline_defaults() -> dict:
    """The headline's rows, cols and size from ``SRT_BENCH_ROWS``,
    ``SRT_BENCH_COLS`` and ``SRT_BENCH_SIZE`` (JAX's tools' variables)."""
    return dict(rows=env_int("SRT_BENCH_ROWS", 160),
                cols=env_int("SRT_BENCH_COLS", 320),
                size=env_int("SRT_BENCH_SIZE", 1024))


def cli_device(tool: str, device):
    """The device of a tool's ``main``: ``devices.resolve(device)``, or
    None after printing why (no card and no ``--device cpu``)."""
    try:
        return resolve(device)
    except RuntimeError as e:
        print(f"{tool}: {e}", file=sys.stderr)
        return None


def add_device(ap) -> None:
    ap.add_argument("--device", help="default: the card; 'cpu' runs the "
                                     "kernels' plain versions")


def add_headline(ap, reps: int) -> None:
    """``--device``, ``--rows``, ``--cols``, ``--size`` and ``--reps``."""
    d = headline_defaults()
    add_device(ap)
    ap.add_argument("--rows", type=int, default=d["rows"])
    ap.add_argument("--cols", type=int, default=d["cols"])
    ap.add_argument("--size", type=int, default=d["size"])
    ap.add_argument("--reps", type=int, default=reps)


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    'cpu' (no device metric is measured there)."""
    if dev.type != "cuda":
        return "cpu"
    try:
        proc = subprocess.run(
            ["nvidia-smi", "-i", str(dev.index or 0),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        line = proc.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        line = f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return line


def header(tool: str, dev: torch.device, verbose: bool = True) -> str:
    """Print (when ``verbose``) and return the tool's first line."""
    card = card_line(dev)
    if verbose:
        print(f"{tool}: {card}", flush=True)
    return card


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_s(fn, *args, dev: torch.device, reps: int = 5, warm: int = 1):
    """Seconds a call: ``warm`` calls, then ``reps`` back to back and one
    synchronise (JAX's ``timeit``)."""
    for _ in range(warm):
        fn(*args)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    sync(dev)
    return (time.perf_counter() - t0) / max(1, reps)


def device_ms(fn, dev: torch.device, n: int = 20, spin_ms: float = 20.0):
    """Device ms of one ``fn()`` call: ``n`` calls enqueued behind a spin
    kernel of ``spin_ms`` (doubled until it outlasts their dispatch, up to
    three times), timed between two CUDA events.  Returns (ms, queued):
    ``queued`` False means the spin ended first and the time holds host
    gaps.  (None, False) on the CPU."""
    if dev.type != "cuda":
        return None, False
    fn()
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(1 << 20)
    b = torch.cuda.Event(enable_timing=True)
    b.record()
    torch.cuda.synchronize(dev)
    cycles_per_ms = (1 << 20) / max(a.elapsed_time(b), 1e-6)
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        queued = not a.query()
        torch.cuda.synchronize(dev)
        if queued:
            break
        spin_ms *= 2.0
    return a.elapsed_time(b) / n, queued


class KernelTimes:
    """CUDA-event pairs around the launches of some kernels; ``ms(name)``
    sums them after a synchronise (None on the CPU: nothing launches)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.events = {}

    def ms(self, name: str):
        if self.dev.type != "cuda":
            return None
        sync(self.dev)
        return sum(a.elapsed_time(b) for a, b in self.events.get(name, ()))

    def count(self, name: str) -> int:
        return len(self.events.get(name, ()))


@contextlib.contextmanager
def kernel_times(dev: torch.device, names):
    """Within the block, each launch of a kernel in ``names`` (wrapper
    names, ``cuda_lib.launch_counts`` keys) is bracketed by two CUDA
    events on its stream; yields a ``KernelTimes``.  An event pair holds
    the kernel and the gap to its launch when the card waits on the
    host."""
    from srt_tpu_torch.ops import traversal

    times = KernelTimes(dev)
    orig = traversal._launch

    def bracketed(name, *args):
        if name not in names:
            return orig(name, *args)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        orig(name, *args)
        b.record()
        times.events.setdefault(name, []).append((a, b))

    traversal._launch = bracketed
    try:
        yield times
    finally:
        traversal._launch = orig


def headline_scene(dev, rows: int = 160, cols: int = 320):
    """``uv_sphere(rows, cols, radius=2.0)`` with walk tables (the
    headline at 160 x 320: 101,760 triangles)."""
    return mesh.upload(flatten_models([uv_sphere(rows, cols, radius=2.0)],
                                      pad_to=128), dev)


def rubik_scene(dev):
    """``procgen.rubik_grid()`` with walk tables: the JAX tools load the
    reference's Rubik OBJ, which the repository does not hold; JAX's own
    ``bench_suite.py`` falls back to this grid, as the port does."""
    return mesh.upload(flatten_models([rubik_grid()], pad_to=128), dev)


def camera(size: int, pose: dict) -> CameraConfig:
    return CameraConfig(width=size, height=size, **pose)


def _unoccluded(closest_hit, p, light_pos, t_min, active):
    return torch.zeros(p.shape[1], dtype=torch.bool, device=p.device)


@contextlib.contextmanager
def no_shadow_rays():
    """Within the block every shadow query answers "not occluded" and
    traces nothing (``pathtracer._occluded`` stubbed, restored after)."""
    real = pathtracer._occluded
    pathtracer._occluded = _unoccluded
    try:
        yield
    finally:
        pathtracer._occluded = real


def popcount16(words):
    """Set bits of each 16-bit word (numpy int array)."""
    pc = np.zeros(words.shape, np.int64)
    for k in range(16):
        pc += (words >> k) & 1
    return pc


def live_width(n_alive: int, n: int) -> int:
    """JAX's tools' slice of a live-first wavefront: the live rays rounded
    up to 4,096, at least 4,096, at most n."""
    return min(max(4096, -(-n_alive // 4096) * 4096), n)


def profiled(fn, dev: torch.device, trace_dir=None, top: int = 40):
    """Run ``fn()`` once under ``torch.profiler``
    (``utils/profiling.profile_trace``), writing ``trace.json`` into
    ``trace_dir`` (a new temporary directory when None), and sum its
    device operations (``parse_trace.summarize``).  Returns (summary,
    path); the summary's ``total_ms`` is None on the CPU."""
    import tempfile

    from srt_tpu_torch.tools import parse_trace
    from srt_tpu_torch.utils.profiling import profile_trace

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="srt_trace_")
    with profile_trace(trace_dir):
        fn()
        sync(dev)
    path = os.path.join(trace_dir, "trace.json")
    summary = parse_trace.summarize(path, top)
    if dev.type != "cuda":
        summary["total_ms"] = None
    return summary, path


def device_ops(fn, dev: torch.device):
    """(device operations, their summed device ms) of one ``fn()`` call:
    the kernels, copies and sets the call puts on the card, read from a
    ``torch.profiler`` trace (``parse_trace.summarize``) in a temporary
    directory that is removed after.  Each profiler window records a
    warm-up call and keeps the second; of three windows the fullest is
    kept, since a window can miss kernels (on the H100, late in a long
    process: 0 of a call's 1, 93 of 100).  (None, None) on the CPU, where
    nothing is launched."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    from srt_tpu_torch.tools import parse_trace

    if dev.type != "cuda":
        return None, None
    best = (0, 0.0)
    for _ in range(3):
        with tempfile.TemporaryDirectory(prefix="srt_trace_") as tmp:
            path = os.path.join(tmp, "trace.json")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: p.export_chrome_trace(path)
                         ) as prof:
                for _ in range(2):
                    fn()
                    sync(dev)
                    prof.step()
            summary = parse_trace.summarize(path, top=0)
        best = max(best, (summary["events"], summary["total_ms"]))
    return best
