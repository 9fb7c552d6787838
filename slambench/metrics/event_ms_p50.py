"""Median wall time of the keyframe events the mapping worker finished in
the window, local mapping plus the loop stage (System.mapping_times and
loop_times), ms."""

from slambench.stats import median


def read(run):
    m = median(run["event_times"])
    return None if m is None else 1e3 * m
