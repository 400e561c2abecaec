"""Rank 0's device ms a frame in NCCL kernels (profiler)."""

from srtbench.lib import layers

UNIT = "ms"
LAYER = "collective (parallel/render_sharded._GatherRays, NCCL all-gather)"
MOVES = "mpaths_s"


def read(r):
    if r.trace is None:
        return None
    ms = layers.per_step(r.trace, lambda op: layers.is_kernel(op)
                         and "nccl" in op.name.lower())
    return ms if ms > 0 else None
