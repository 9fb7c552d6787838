"""The profiled slice's wall time that no kernel on any stream covers, %."""


def read(run):
    s = run["slice"]
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"]) if s["wall_s"] > 0 else None
