"""Host ms a frame of the bounce steps less their walks: the port's
``srt.shade`` spans under ``srt.render`` less the ``srt.walk`` spans
inside them, read from the port's span aggregate (``lib/portspans``).
Shading, BRDF and light sampling, the re-sorts and gathers."""

from srtbench.lib import portspans

UNIT = "ms"
LAYER = "bounce step (models/pathtracer.bounce_step, ops/brdf, sorts and gathers)"
MOVES = "mpaths_s"


def read(r):
    tot = portspans.totals()
    return portspans.frame_ms(tot, "shade") if tot else None
