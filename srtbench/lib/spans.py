"""Host spans that the benchmark records around its own calls into the
port's layers (frozen).

``Spans.span(name)`` times a block on the host clock and, while a profiler
window is open (``profiling``), also marks it as a ``record_function``
range, so the trace can tell which layer launched each device operation.
``Spans.wrap(module, attr, name)`` puts such a span around every call of
a module function until ``restore()``; a wrapped call costs one flag test
while no profiler window is open.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time

import torch


class Spans:
    def __init__(self):
        self.seconds = {}          # name -> [seconds of each closed span]
        self.profiling = False
        self._undo = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def wrap(self, module, attr: str, name: str, on_call=None):
        """Span ``module.attr`` as ``name`` while profiling; ``on_call(args,
        kwargs, result)`` also sees every call made while profiling."""
        fn = getattr(module, attr)

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not self.profiling:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            if on_call is not None:
                on_call(args, kwargs, out)
            return out

        setattr(module, attr, spanned)
        self._undo.append((module, attr, fn))
        return spanned

    def wrap_everywhere(self, fn, package: str, name: str,
                        on_call=None) -> None:
        """Span ``fn`` as ``wrap`` does, in every module of ``package`` that
        holds it under any name (a module may have bound it at import)."""
        for mod_name, module in list(sys.modules.items()):
            if module is None or not (mod_name == package
                                      or mod_name.startswith(package + ".")):
                continue
            for attr, value in list(vars(module).items()):
                if value is fn:
                    self.wrap(module, attr, name, on_call)

    def restore(self) -> None:
        while self._undo:
            module, attr, fn = self._undo.pop()
            setattr(module, attr, fn)
