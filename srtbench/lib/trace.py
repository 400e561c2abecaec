"""Profiler windows and their reading (frozen).

``capture(step, n)`` runs ``step(i)`` for one warm-up and ``n`` traced
steps under ``torch.profiler`` (CPU and CUDA activity), writes the Chrome
trace into a temporary directory under ``TMPDIR``, reads it back and
removes it.  ``Trace`` then holds every device operation (kernels, copies,
sets) with the host spans that were open on the launching thread when it
was launched (linked by the launch's correlation id): the benchmark's own
``srtbench.*`` spans, PyTorch's ``aten::*`` operations and the autograd
engine's ``autograd::engine::evaluate_function: *`` ranges.  The traced
window runs from the first ``srtbench.step`` span's start to the last
one's end; ``busy_s`` is the union of device operation intervals inside
it.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import tempfile
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
STEP = "srtbench.step"

# A device operation: its name, start and length (us), the host spans open
# where it was launched (outermost first) and its category.
Op = collections.namedtuple("Op", "name ts dur ctx cat")


class Window:
    """A profiler window stepped by hand: ``begin()``, then ``step()`` at
    the end of each step (the first is a warm-up, not traced), and after
    ``n`` traced steps ``done`` is set and ``trace`` holds the reading.
    Each step runs inside a ``srtbench.step`` span; the caller
    synchronises before ``step()``."""

    def __init__(self, n: int, spans=None):
        self.n = n
        self.spans = spans
        self.count = 0
        self.done = False
        self.trace = None
        self._tmp = tempfile.mkdtemp(prefix="srtbench_trace_")
        self._path = os.path.join(self._tmp, "trace.json")
        self._prof = None
        self._span = None

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(
            activities=activities,
            schedule=schedule(wait=0, warmup=1, active=self.n),
            on_trace_ready=lambda p: p.export_chrome_trace(self._path))
        self._prof.start()
        if self.spans is not None:
            self.spans.profiling = True
        self._open()

    def _open(self) -> None:
        self._span = torch.profiler.record_function(STEP)
        self._span.__enter__()

    def step(self) -> None:
        self._span.__exit__(None, None, None)
        self._prof.step()
        self.count += 1
        if self.count <= self.n:
            self._open()
            return
        self._prof.stop()
        if self.spans is not None:
            self.spans.profiling = False
        try:
            with open(self._path) as f:
                self.trace = Trace(json.load(f)["traceEvents"])
        finally:
            shutil.rmtree(self._tmp, ignore_errors=True)
        self.done = True


def capture(step, n: int, spans=None) -> "Trace":
    """Profile ``n`` calls of ``step(i)`` after one warm-up call; each call
    runs inside a ``srtbench.step`` span and ends synchronised."""
    win = Window(n, spans)
    win.begin()
    i = 0
    while not win.done:
        step(i)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        win.step()
        i += 1
    return win.trace


class _Thread:
    """One host thread's spans, sorted by start (the longest first)."""

    def __init__(self, intervals):
        intervals.sort(key=lambda x: (x[0], -x[1]))
        self.intervals = intervals

    def context(self, times):
        """For each time, the names of the spans open at it, outermost
        first: one sweep with a stack, since spans on a thread nest."""
        out = [()] * len(times)
        stack = []
        j = 0
        for qi in sorted(range(len(times)), key=times.__getitem__):
            t = times[qi]
            while j < len(self.intervals) and self.intervals[j][0] <= t:
                s = self.intervals[j][0]
                while stack and stack[-1][1] < s:
                    stack.pop()
                stack.append(self.intervals[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out[qi] = tuple(n for _, e, n in stack if e >= t)
        return out


class Trace:
    """The device operations of a profiler window, each with its host
    context, and the window itself (microseconds)."""

    def __init__(self, events):
        threads = {}
        launches = {}
        steps = []
        devops = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            key = (ev.get("pid"), ev.get("tid"))
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            if cat in HOST_CATS:
                threads.setdefault(key, []).append((ts, ts + dur,
                                                    ev["name"]))
                if ev["name"] == STEP:
                    steps.append((ts, ts + dur, key))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (key, ts)
            elif cat in DEVICE_CATS:
                devops.append(ev)
        if not steps:
            raise RuntimeError("the trace holds no srtbench.step span")
        self.threads = {k: _Thread(v) for k, v in threads.items()}
        self.t0 = min(s for s, _, _ in steps)
        self.t1 = max(e for _, e, _ in steps)
        self.n_steps = len(steps)
        self.main = steps[0][2]
        by_thread = {}
        for i, ev in enumerate(devops):
            link = launches.get(ev.get("args", {}).get("correlation"))
            if link is not None:
                by_thread.setdefault(link[0], []).append((i, link[1]))
        ctx = [()] * len(devops)
        for key, items in by_thread.items():
            th = self.threads.get(key)
            if th is None:
                continue
            for (i, _), c in zip(items, th.context([t for _, t in items])):
                ctx[i] = c
        self.ops = [Op(ev["name"], float(ev["ts"]), float(ev.get("dur", 0.0)),
                       ctx[i], ev["cat"]) for i, ev in enumerate(devops)
                    if self.t0 <= float(ev["ts"]) <= self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _merged(self):
        spans = sorted((max(op.ts, self.t0), min(op.ts + op.dur, self.t1))
                       for op in self.ops)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            elif b > a:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged()) / 1e6

    def device_ms(self, keep) -> float:
        """Device ms of the operations ``keep(op)`` selects, summed over
        the window."""
        return sum(op.dur for op in self.ops if keep(op)) / 1e3

    def top_ops(self, k: int = 10):
        tot = {}
        for op in self.ops:
            short = op.name[:160]
            tot[short] = tot.get(short, 0.0) + op.dur / 1e6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10):
        """Idle device time summed by what the host was doing in the middle
        of each gap: the innermost benchmark span and the innermost
        operation open on the main thread."""
        merged = self._merged()
        edges = [self.t0] + [x for ab in merged for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        th = self.threads[self.main]
        ctxs = th.context([(a + b) / 2 for a, b in gaps])
        tot = {}
        for (a, b), c in zip(gaps, ctxs):
            ours = [n for n in c if n.startswith("srtbench.")
                    and n != STEP]
            ops = [n for n in c if not n.startswith(("srtbench.",
                                                     "ProfilerStep"))]
            label = "/".join(x for x in ((ours[-1] if ours else ""),
                                         (ops[-1] if ops else "host"))
                             if x)
            tot[label] = tot.get(label, 0.0) + (b - a) / 1e6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]
