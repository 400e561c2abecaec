"""Rank 0's host ms a frame from the ``render_sharded`` call to its
return, before the synchronise: the benchmark's ``srtbench.dispatch``
span, in frames traced by spans alone (no profiler)."""

UNIT = "ms"
LAYER = "sharded integrator (parallel/render_sharded, models/pathtracer.trace_wavefront)"
MOVES = "mpaths_s"


def read(r):
    s = r.spans.get("srtbench.dispatch")
    return 1e3 * sum(s) / len(s) if s else None
