"""Device ms a step of the gathers' backward: kernels launched inside
``aten::index_put_`` (and its ``_index_put_impl_``) or named
``indexing_backward`` under the backward (profiler)."""

from srtbench.lib import layers

UNIT = "ms"
LAYER = "autograd backward (torch.autograd through models/pathtracer.render)"
MOVES = "step_s"


def _gather(op):
    return layers.is_kernel(op) and layers.in_span(op, layers.BACKWARD) and (
        layers.in_span(op, "aten::index_put_")
        or layers.in_span(op, "aten::_index_put_impl_")
        or "indexing_backward" in op.name)


def read(r):
    if r.trace is None:
        return None
    ms = layers.per_step(r.trace, _gather)
    return ms if ms > 0 else None
