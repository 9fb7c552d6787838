"""Faults planted in the timed path, to show that a run with one comes
out not correct (tests/test_slambench_faults.py on the CPU, control.py on
the card). Each takes the built ``program.Program`` and returns the
callable that takes the fault out again."""

from __future__ import annotations

import torch

from anyfeature_vslam_tpu_torch.ops import cuda_match


def state_unchanged(prog):
    """Every tracked frame returns the state it was given: the pose each
    frame records is the first tracked frame's."""
    tracker = prog.system.tracker
    finish = tracker._finish_frame
    held = {}

    def finish_unchanged(frame):
        if frame.pose is not None:
            if "pose" in held:
                frame.pose = held["pose"].copy()
            held.setdefault("pose", frame.pose.copy())
        finish(frame)

    tracker._finish_frame = finish_unchanged
    return lambda: setattr(tracker, "_finish_frame", finish)


def descriptors_altered(prog):
    """The extractor's descriptors altered where they are produced: every
    seventh bit flipped (binary), or every seventh element moved by 0.05
    (float)."""
    ext = prog.system.tracker.extractor
    forward = ext.forward

    def altered(image):
        out = dict(forward(image))
        d = out["desc_bits"].clone()
        if d.dtype == torch.uint8:
            d[:, ::7] ^= 1
        else:
            d[:, ::7] += 0.05
        out["desc_bits"] = d
        return out

    ext.forward = altered
    return lambda: setattr(ext, "forward", forward)


def matches_altered(prog):
    """K2's answers altered where they are produced: every other query's
    best candidate moved to the next candidate."""
    best_two = cuda_match.best_two

    def altered(q_feat, c_feat, *args, **kw):
        best, idx, second = best_two(q_feat, c_feat, *args, **kw)
        nc = (c_feat[0] if isinstance(c_feat, tuple) else c_feat).shape[0]
        odd = torch.arange(idx.shape[0], device=idx.device) % 2 == 1
        idx = torch.where(odd & (idx >= 0), (idx + 1) % max(nc, 1), idx).to(idx.dtype)
        return best, idx, second

    altered.launches = best_two.launches
    cuda_match.best_two = altered

    def undo():
        best_two.launches = altered.launches
        cuda_match.best_two = best_two

    return undo


FAULTS = {"state_unchanged": state_unchanged, "descriptors_altered": descriptors_altered,
          "matches_altered": matches_altered}
