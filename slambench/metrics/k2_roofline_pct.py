"""K2 (csrc/best_two.cu, with its pack_bits launches) over the profiled
slice: the launches' least time (roofline.py) over their device time, %."""

from slambench.trace import roofline_pct


def read(run):
    return roofline_pct(run["slice"], ("k2", "pack"))
