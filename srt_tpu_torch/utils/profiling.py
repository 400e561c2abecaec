"""Performance instrumentation: rays/s meters and profiler hooks
(counterpart of ``srt_tpu/utils/profiling.py``).

The reference prints a frame time every 60 frames (src/main.cpp:616-620).
Here: a ``RaysPerSecondMeter`` that counts the rays actually traced (the
integrator's per-bounce stats), wall-clock timing that waits for the
card, and ``torch.profiler`` trace capture.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class Timer:
    """Wall-clock timer (``with Timer() as t: ...``; ``t.elapsed`` s).
    Work queued on the card inside the block is not waited for: end the
    block with ``torch.cuda.synchronize()`` to time it."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def _on_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (tuple, list)):
        return any(_on_cuda(v) for v in x)
    if isinstance(x, dict):
        return any(_on_cuda(v) for v in x.values())
    return False


def _wait(result, sync: bool):
    if sync and _on_cuda(result):
        torch.cuda.synchronize()


def timed(fn, *args, sync=True, repeats=1):
    """Run ``fn(*args)`` once to warm up, then ``repeats`` times; returns
    (result, seconds a call) of the steady state.  With ``sync`` the card
    is synchronised after the warm-up and after the timed calls when any
    output tensor lies on it."""
    result = fn(*args)
    _wait(result, sync)
    t0 = time.perf_counter()
    for _ in range(repeats):
        result = fn(*args)
    _wait(result, sync)
    return result, (time.perf_counter() - t0) / max(1, repeats)


class RaysPerSecondMeter:
    """Accumulates traced-ray counts (closest-hit + shadow rays from the
    integrator's stats) against wall time."""

    def __init__(self):
        self.rays = 0
        self.seconds = 0.0

    def add(self, stats, seconds: float, spp: int = 1):
        """stats: [B, 2] per-bounce (trace, shadow) counts for ONE sample
        (a tensor on any device, or an array)."""
        self.rays += int(torch.as_tensor(stats).sum()) * spp
        self.seconds += seconds

    @property
    def mrays_per_s(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds else 0.0


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the block (CPU, and the card
    when there is one) and write it to ``log_dir/trace.json`` (Chrome
    trace format: chrome://tracing or Perfetto).  ``log_dir`` None or
    empty: no trace."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
