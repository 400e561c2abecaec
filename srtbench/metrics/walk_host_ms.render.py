"""Host ms a frame of the walks: the port's ``srt.walk`` spans under
``srt.render`` (one ``traversal.model_hit`` call each: ray packing, the
tables, the B1-B4 launches, the refine), read from the port's span
aggregate (``lib/portspans``)."""

from srtbench.lib import portspans

UNIT = "ms"
LAYER = "walk kernels (ops/traversal.model_hit, csrc B1-B4)"
MOVES = "mpaths_s"


def read(r):
    tot = portspans.totals()
    return portspans.frame_ms(tot, "walk") if tot else None
