"""Window statistics (frozen): rates and tails, host clock."""

from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work finished in the window over the window's seconds."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value (no chunks, no
    interpolation): the smallest value with at least ``q`` % of the values
    at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]
