"""The walk kernels' share of their roofline over one traced frame:
the sum of each walk call's bound (``lib/walkwork``: the larger of its
bytes at 3.35 TB/s and its instructions on the busier pipe, counted from
the call's rays and the scene's tables) over the device time of the walk
kernels of that frame, in %.

The bounds come from the ``ops/traversal.model_hit`` calls that the
benchmark saw (``srtbench.walk`` spans); the time from the walk kernels
by name.  Where a walk kernel of the frame ran outside every such span,
some walk was not counted, and the share is not read."""

from srtbench.lib import layers, walkwork

UNIT = "%"
LAYER = "walk kernels (ops/traversal.model_hit, csrc B1-B4)"
MOVES = "mpaths_s"


def read(r):
    if r.trace is None or not r.work:
        return None

    def frame_walk(op):
        return layers.walk_kernel(op) and layers.in_span(op, layers.CAPTURE)

    if r.trace.device_ms(lambda op: frame_walk(op)
                         and not layers.in_span(op, layers.WALK)) > 0:
        return None
    ms = r.trace.device_ms(frame_walk)
    if ms <= 0:
        return None
    return 100.0 * sum(walkwork.bound_s(w) for w in r.work) / (ms / 1e3)
