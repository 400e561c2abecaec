"""Device ms a frame of memory copies and sets (host to device, device
to device, fills; profiler): what is left of the frame's device time
beside ``walk_ms.render`` and ``elementwise_ms.render``."""

from srtbench.lib import layers

UNIT = "ms"
LAYER = "device"
MOVES = "mpaths_s"


def read(r):
    if r.trace is None:
        return None
    ms = layers.per_step(r.trace, layers.is_copy)
    return ms if ms > 0 else None
