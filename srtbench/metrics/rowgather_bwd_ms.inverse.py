"""Device ms a step of the row gathers' backward: kernels launched inside
the port's ``srt.gather_bwd`` span (``ops/gather.gather_rows_backward``:
the indices' sort, the zeroed table and the two launches of
``csrc/gather_bwd.cu``) under the backward (profiler).  A port without
that span gives None."""

from srtbench.lib import layers

UNIT = "ms"
LAYER = "autograd backward (torch.autograd through models/pathtracer.render)"
MOVES = "step_s"
SPAN = "srt.gather_bwd"


def read(r):
    if r.trace is None:
        return None
    ms = layers.per_step(r.trace, lambda op: layers.is_kernel(op)
                         and layers.in_span(op, layers.BACKWARD)
                         and layers.in_span(op, SPAN))
    return ms if ms > 0 else None
