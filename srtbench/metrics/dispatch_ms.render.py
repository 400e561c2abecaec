"""Host ms a frame from the ``RenderPlan.render`` call to its return,
before the synchronise: the benchmark's ``srtbench.dispatch`` span, in
frames traced by spans alone (no profiler)."""

UNIT = "ms"
LAYER = "render plan and compact driver (models/fastpath, models/wavefront_compact)"
MOVES = "mpaths_s"


def read(r):
    s = r.spans.get("srtbench.dispatch")
    return 1e3 * sum(s) / len(s) if s else None
