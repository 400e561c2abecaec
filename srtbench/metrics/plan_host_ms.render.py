"""Host ms a frame of the render plan and compact driver outside the
bounce steps: the port's ``srt.render`` spans less their ``srt.shade``
spans (and any walk outside one), read from the port's span aggregate
(``lib/portspans``).  Ray generation, compaction, the uniforms, the final
scatter and the mean over samples.  With ``shade_host_ms.render`` and
``walk_host_ms.render`` it adds up to the frame's host time."""

from srtbench.lib import portspans

UNIT = "ms"
LAYER = "render plan and compact driver (models/fastpath, models/wavefront_compact)"
MOVES = "mpaths_s"


def read(r):
    tot = portspans.totals()
    return portspans.frame_ms(tot, "plan") if tot else None
