"""Kernel events per frame over the profiled slice."""


def read(run):
    s = run["slice"]
    return s["kernels"] / s["frames"] if s["frames"] else None
