"""Device ms a frame of every kernel that is not a walk kernel: the
bounce step's PyTorch operations, sorts, gathers and compaction, and the
uniforms' threefry (profiler).  With ``walk_ms.render`` and
``copy_ms.render`` it adds up to the frame's device time."""

from srtbench.lib import layers

UNIT = "ms"
LAYER = "bounce step (models/pathtracer.bounce_step, ops/brdf, sorts and gathers)"
MOVES = "mpaths_s"


def read(r):
    if r.trace is None:
        return None
    ms = layers.per_step(r.trace, layers.elementwise)
    return ms if ms > 0 else None
