"""Device ms a frame of the walk kernels, picked out by their names in
the port's csrc (``lib/layers.WALK_KERNELS``; profiler)."""

from srtbench.lib import layers

UNIT = "ms"
LAYER = "walk kernels (ops/traversal.model_hit, csrc B1-B4)"
MOVES = "mpaths_s"


def read(r):
    if r.trace is None:
        return None
    ms = layers.per_step(r.trace, layers.walk_kernel)
    return ms if ms > 0 else None
