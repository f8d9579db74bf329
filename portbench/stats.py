"""Statistics of a run's window."""

from __future__ import annotations

import math


def percentile(values, pct: float) -> float:
    """The nearest-rank percentile: the smallest value with at least
    ``pct`` percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    rank = max(1, math.ceil(pct / 100.0 * len(xs)))
    return xs[rank - 1]


def per_call_ms(window_s: float, calls: int) -> float:
    """The window's seconds x 1000 over the calls completed in it."""
    if calls <= 0:
        raise ValueError("no call completed in the window")
    return 1000.0 * window_s / calls
