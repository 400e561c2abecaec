"""Host seconds of the port's scene build: the benchmark's span around
``utils.flatten.flatten_models`` and ``models.mesh.upload``."""

UNIT = "s"
LAYER = "set-up (utils/flatten, models/mesh.upload)"
MOVES = "setup_s"


def read(r):
    return r.extra.get("scene_build_s")
