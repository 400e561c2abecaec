"""Device operations (kernels, copies, sets) a traced frame that were
launched inside the port's ``srt.render`` span (profiler): the work the
host dispatches a frame, one launch at a time."""

from srtbench.lib import portspans

UNIT = "ops"
LAYER = "render plan and compact driver (models/fastpath, models/wavefront_compact)"
MOVES = "mpaths_s"


def read(r):
    if r.trace is None:
        return None
    n = sum(1 for op in r.trace.ops if portspans.RENDER in op.ctx)
    return n / r.trace.n_steps if n else None
