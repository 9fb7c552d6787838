"""Host syncs per frame over the profiled slice, both threads: the
blocking CUDA runtime calls (stream, device and event synchronisations)
in the trace, the slice's own two bounds left out."""


def read(run):
    s = run["slice"]
    return s["syncs"] / s["frames"] if s["frames"] else None
