"""Million paths a second: width x height x spp of every frame finished
in the window, over the window's seconds (host clock)."""

from srtbench.lib import stats


def read(window):
    if window.frame_s is None:
        return None
    return stats.rate(window.paths_per_frame * len(window.frame_s),
                      window.seconds) / 1e6
