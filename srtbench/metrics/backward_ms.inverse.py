"""Device ms a step of the kernels launched under the autograd engine's
backward (``autograd::engine::evaluate_function`` ranges; profiler)."""

from srtbench.lib import layers

UNIT = "ms"
LAYER = "autograd backward (torch.autograd through models/pathtracer.render)"
MOVES = "step_s"


def read(r):
    if r.trace is None:
        return None
    ms = layers.per_step(r.trace, lambda op: layers.is_kernel(op)
                         and layers.in_span(op, layers.BACKWARD))
    return ms if ms > 0 else None
