"""Share of the traced window with no device operation running, frames
back to back (rank 0 on four cards), in %."""

UNIT = "%"
LAYER = "device"
MOVES = "mpaths_s"


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
