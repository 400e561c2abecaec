"""Seconds a step: the window's seconds over the steps it completed
(host clock)."""

from srtbench.lib import stats


def read(window):
    if window.step_s is None:
        return None
    return 1.0 / stats.rate(len(window.step_s), window.seconds)
