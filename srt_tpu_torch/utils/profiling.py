"""Performance instrumentation: spans at the renderer's layer boundaries,
rays/s meters and profiler hooks (counterpart of
``srt_tpu/utils/profiling.py``).

The reference prints a frame time every 60 frames (src/main.cpp:616-620).
Here: named spans (``span``), a ``RaysPerSecondMeter`` that counts the
rays actually traced (the integrator's per-bounce stats), and
``torch.profiler`` trace capture.

**Spans.**  ``with span("srt.walk"): ...`` marks one stage of the
renderer.  Each span goes to exactly one of two sinks, chosen when it is
entered:

* while a ``torch.profiler`` window records, a ``record_function`` range,
  so the span lies on the profiler's timeline beside the device
  operations it launched (they carry it in their launch context);
* otherwise the span's host-clock seconds and one call are added to an
  in-memory aggregate keyed by its path, the names of the open spans
  from the outermost down, joined by ``/``
  (``srt.render/srt.bounce.2/srt.shade/srt.walk``).

So host times in the aggregate never include the profiler's own cost.
The aggregate is a tree of the span names seen, so it grows with the
fixed set of names, not with the calls; ``span_totals()`` reads it and
``reset_spans()`` clears it.  Spans are opened from one host thread at a
time: the one that drives the renderer, or the autograd engine's while
that one waits in ``backward()``.  The spans and what each covers:

* ``srt.render``: one ``RenderPlan.render`` frame;
* ``srt.raygen``: the compact driver's ray generation (jitter, viewport,
  rays, the Morton permutation and its upload);
* ``srt.bounce.<b>``: pass ``b`` (from 1) of the compact driver's bounce
  loop; its self time is the compaction;
* ``srt.shade``: one ``pathtracer.bounce_step``, its walks included;
* ``srt.walk``: one ``traversal.model_hit``;
* ``srt.forward``, ``srt.backward``, ``srt.update``: an optimizer step's
  loss, ``backward()`` and update with its projection;
* ``srt.gather_bwd``: one row gather's backward
  (``ops/gather.gather_rows_backward``: the sort and the kernel launches);
* ``srt.setup.flatten``, ``srt.setup.plan``, ``srt.setup.kernels``: scene
  flattening, building a render plan (its probe frame included) and
  loading (building when stale) the kernel library.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

# True while a torch.profiler window records (not in its warm-up steps).
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Node:
    """One path of the aggregate: its child spans by name, its closed
    calls and their seconds."""

    __slots__ = ("children", "calls", "seconds")

    def __init__(self):
        self.children = {}
        self.calls = 0
        self.seconds = 0.0


_root = _Node()
_open = [_root]          # the aggregate's open spans, innermost last


class _Span:
    __slots__ = ("name", "node", "t0", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiler_enabled():
            self.node = None
            self.record = torch.profiler.record_function(self.name)
            self.record.__enter__()
            return self
        parent = _open[-1]
        node = parent.children.get(self.name)
        if node is None:
            node = parent.children[self.name] = _Node()
        _open.append(node)
        self.node = node
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        node = self.node
        if node is None:
            self.record.__exit__(*exc)
            return False
        node.seconds += time.perf_counter() - self.t0
        node.calls += 1
        _open.pop()
        return False


def span(name: str) -> _Span:
    """A context manager marking one stage of the renderer as ``name``:
    a profiler range while a ``torch.profiler`` window records, else host
    seconds added to the aggregate under the span's path."""
    return _Span(name)


def span_totals() -> dict:
    """A copy of the aggregate: ``{path: (calls, seconds)}`` for every
    path with a closed span."""
    out = {}
    stack = [("", _root)]
    while stack:
        prefix, node = stack.pop()
        for name, child in node.children.items():
            path = prefix + name
            if child.calls:
                out[path] = (child.calls, child.seconds)
            stack.append((path + "/", child))
    return out


def reset_spans() -> None:
    """Empty the aggregate (spans open now still close without error)."""
    _root.children.clear()


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
