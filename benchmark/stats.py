"""The arithmetic of the end-to-end and device metrics."""
from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile (0-100) with linear interpolation between closest ranks, as
    ``numpy.percentile``'s default."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work per second over a whole window."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return count / seconds


def idle_share(busy_s: float, window_s: float) -> float:
    """The share of a window in which no device operation ran."""
    return 1.0 - busy_s / window_s

