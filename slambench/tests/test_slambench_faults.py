"""A run with the timed path broken underneath comes out not correct.

Each test drives the harness's whole run on the CPU at half the cell's
size (the look for a card skipped), with one fault of faults.py planted
in the window's path: a tracked frame that returns the state it was
given, and an answer altered where it is produced (the extractor's
descriptors; K2's matches). A run that a fault stops before it gives a
result has failed as well. The
reference in bfloat16 put in the program's place (the control) must
fail too. A cell has no batch and no exchange between chips, so those
faults do not apply. The window closes after a number of frames, not of
seconds, so that what it holds does not follow the host's speed; the
frozen pose's window is long enough for the camera to travel further
than the cell's limit on ate_cm."""

import math

import pytest

from slambench import faults, harness

WORKLOAD = "sift128_tum1.explore"
# frames in the window: the frozen pose misses the path by more as it grows
FRAMES = {"state_unchanged": 30, "descriptors_altered": 4, "matches_altered": 4}


def _small_spec():
    spec = harness.load_cell(WORKLOAD)
    cam = spec["config"]["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] *= 0.5
    cam["width"], cam["height"] = 320, 240
    spec["traffic"]["frames"] = 100
    return spec


def _run(tamper=None, control=False, frames=3):
    return harness.run(_small_spec(), 2 ** 31 + 21, 3600.0, False, device="cpu",
                       tamper=tamper, control=control, window_frames=frames)


# a step that returns its state unchanged; an answer altered where it is
# produced, in the frontend and in K2
@pytest.mark.parametrize("fault", ["state_unchanged", "descriptors_altered", "matches_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(fault):
    try:
        res = _run(tamper=faults.FAULTS[fault], frames=FRAMES[fault])
    except harness.RunError:
        return  # no result: the run has failed
    assert res["correct"] is False


def test_a_sound_run_and_its_control():
    res = _run(control=True)
    assert all(math.isfinite(c["value"]) for c in res["checks"].values())
    assert res["checks"]["frontend_bad_pct"]["value"] == 0.0
    # K2's float search is within float32 rounding of the reference's
    assert res["checks"]["k2_gap"]["value"] <= res["checks"]["k2_gap"]["limit"]
    assert res["readings"]["k2_queries"] > 0
    assert harness.passes(res["checks"])
    assert not harness.passes(res["control_checks"])
    c = res["control_checks"]["frontend_bad_pct"]
    assert c["value"] > c["limit"]
