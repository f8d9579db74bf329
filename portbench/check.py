"""Whether the timed path's output is correct: each number that the
cell's kind reads from the sampled calls against its plain reference
(``kinds/<kind>.py``'s ``readings``) held to the cell's limit.
"""

from __future__ import annotations

import math


def worst(a, b):
    """The larger of two readings; NaN wins."""
    if a is None or (isinstance(b, float) and math.isnan(b)):
        return b
    if isinstance(a, float) and math.isnan(a):
        return a
    return max(a, b)


def verdict(limits: dict, found: dict):
    """(correct, [(name, value, limit)]): each number at or under its
    limit (a missing or NaN reading fails)."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = found.get(name, float("nan"))
        rows.append((name, value, limit))
        ok = ok and value <= limit
    return ok, rows
