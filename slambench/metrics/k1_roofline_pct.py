"""K1 (csrc/fast_nms.cu) over the profiled slice: its launches' least
time (roofline.py) over their device time, %."""

from slambench.trace import roofline_pct


def read(run):
    return roofline_pct(run["slice"], ("k1",))
