"""The arithmetic of the metrics: a rate over a window, a percentile over
all of its samples, and the union of intervals on a device timeline."""

from __future__ import annotations

import math


def rate(count: int, t_start: float, t_end: float) -> float:
    """count per second over [t_start, t_end]: the window's whole time, its
    final drain included."""
    return count / (t_end - t_start)


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (the smallest value with at least
    q% of the samples at or below it) over every sample."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    return v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)]


def median(values):
    v = sorted(values)
    if not v:
        return None
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def union(intervals):
    """The disjoint, sorted union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def busy(intervals) -> float:
    """Total length of the union of the intervals."""
    return sum(b - a for a, b in union(intervals))


def gaps(intervals, start: float, end: float):
    """The idle (start, end) stretches of [start, end] that no interval
    covers."""
    out, t = [], start
    for a, b in union(intervals):
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
    if t < end:
        out.append((t, end))
    return [g for g in out if g[1] > g[0]]
