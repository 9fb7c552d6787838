"""The port's rebuild of an ambiguous monocular initialization
(slam/tracking.py:_rebuild_ambiguous_initialization).

On the rendered benchmark scene at 640x480 with 1000 anyfeat_bin features,
frames 0 and 1 pass the 1-degree parallax gate of the two-view
initialization, and the next frame is tracked with almost no translation,
in the JAX package as in the port (ROADMAP.md section 3): the port then
rebuilds the initial map from frames 0 and 2. At 320x240 with orb32 the
frame after initialization moves, and nothing is rebuilt.
"""

from types import SimpleNamespace

import numpy as np

from anyfeature_vslam_tpu_torch.system import System
from torch_slice_scene import SliceScene


def _centre(t):
    t = t.astype(np.float64)
    return -t[:3, :3].T @ t[:3, 3]


def _run(feature, width, height, n_features, n_frames, **kw):
    sc = SliceScene(width, height)
    system = System(SimpleNamespace(**sc.camera), feature=feature, n_features=n_features,
                    device="cpu", **kw)
    states = [system.track_monocular(sc.render(i)[0], i / 30.0).name for i in range(n_frames)]
    return system, states


def test_ambiguous_initialization_is_rebuilt_from_the_wider_pair():
    system, states = _run("anyfeat_bin", 640, 480, 1000, 4)
    st = system.tracker.stats
    assert states == ["NOT_INITIALIZED", "OK", "OK", "OK"]
    assert st["reinitializations"] == 1 and st["resets"] == 0 and st["lost_frames"] == 0
    m = system.map
    by_frame = {int(m.kf_frame_id[k]): m.kf_pose[k] for k in m.keyframe_ids()}
    assert sorted(by_frame)[:2] == [0, 2], sorted(by_frame)
    # frame 1's trajectory entry went with the first map: frames 2 and 3
    assert st["tracked_frames"] == len(system.tracker.trajectory) == 2
    # frame 3 moves on by about the new initial pair's per-frame motion
    step = np.linalg.norm(_centre(by_frame[2]) - _centre(by_frame[0])) / 2
    moved = np.linalg.norm(_centre(system.tracker.last.pose) - _centre(by_frame[2]))
    assert 0.5 * step < moved < 1.5 * step, (moved, step)


def test_initialization_that_moves_on_is_kept():
    system, states = _run("orb32", 320, 240, 600, 3, async_mapping=False)
    st = system.tracker.stats
    assert states == ["NOT_INITIALIZED", "OK", "OK"]
    assert st["reinitializations"] == 0 and st["tracked_frames"] == 2
    m = system.map
    assert sorted(int(m.kf_frame_id[k]) for k in m.keyframe_ids())[:2] == [0, 1]
    assert system.tracker._init_motion is None

