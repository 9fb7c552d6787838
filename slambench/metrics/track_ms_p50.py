"""Median wall time of the window's tracked calls (System.frame_times), ms."""

from slambench.stats import median


def read(run):
    m = median(run["frame_times"])
    return None if m is None else 1e3 * m
