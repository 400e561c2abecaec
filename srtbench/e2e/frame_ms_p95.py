"""The 95th percentile of every frame's time in the window, from the
call to after its synchronise, over all frames (host clock)."""

from srtbench.lib import stats


def read(window):
    if window.frame_s is None:
        return None
    return 1e3 * stats.percentile(window.frame_s, 95)
