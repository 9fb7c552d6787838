"""Keyframe events the mapping worker finished in the window (its final
drain included) per frame handed over."""


def read(run):
    return len(run["event_times"]) / run["frames"] if run["frames"] else None
