"""Host seconds of the port's scene flattening (``flatten_models``: the
BVH build and the flat tables): its ``srt.setup.flatten`` span, read from
the port's span aggregate (``lib/portspans``).  ``scene_build_s`` less
this is the upload with CUDA's start-up."""

from srtbench.lib import portspans

UNIT = "s"
LAYER = "set-up (utils/flatten, models/mesh.upload)"
MOVES = "setup_s"


def read(r):
    tot = portspans.totals()
    if not tot:
        return None
    sec = portspans.seconds(tot, portspans.FLATTEN)
    return sec if sec > 0 else None
