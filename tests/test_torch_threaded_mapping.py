"""The port's threaded schedule on the CPU (System threaded_mapping=True):
the whole keyframe event runs on the mapping worker thread, the tracker is
pipelined (depth 2), the loop stage's BoW folds one keyframe late and a
watcher thread lands each BA fold (reference LocalMapping / LoopClosing
threads, src/System.cc:112-117). Modelled on tests/test_threaded_mapping.py.

Thread interleaving makes the keyframe cadence timing-dependent, so the
bounds are robustness bounds: no reset, at least 28 of 32 frames tracked,
keyframe ATE below 5 cm (tests/test_threaded_mapping.py's bound). The
scene is the rendered relief plane at 320x240 with 600 features on a
faster circle (40 frames around, seed 9, as tests/test_threaded_mapping.py's
sequence). The run goes unpaced, and paced: waiting for the worker to go
idle before each frame, as a camera slower than mapping would, which
mints a keyframe at nearly every retire (the card's cadence, where an
event takes less than a frame). Every run has its own deadline (a hang
fails the test instead of stalling the suite).
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anyfeature_vslam_tpu_torch.io import evaluation
from anyfeature_vslam_tpu_torch.slam.tracking import TrackState
from anyfeature_vslam_tpu_torch.system import System
from span_trace import Tracing
from torch_slice_scene import SliceScene

W, H, N_FEATURES, N_FRAMES = 320, 240, 600, 32
DEADLINE_S = 300.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the port's runs at this size are launch-bound,
    and more threads only oversubscribe the cores other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _within(seconds, fn):
    """fn() on a daemon thread, failing if it has not returned in time."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised on the test's thread
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"did not finish within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


@pytest.fixture(scope="module")
def scene():
    sc = SliceScene(W, H, n_frames=40, seed=9)
    return sc, [sc.render(i)[0] for i in range(N_FRAMES)]


def _system(sc):
    return System(SimpleNamespace(**sc.camera), n_features=N_FEATURES, threaded_mapping=True,
                  device="cpu")


@pytest.mark.parametrize("paced", [True, False])
def test_threaded_system_tracks_and_shuts_down(scene, paced):
    sc, frames = scene
    system = _system(sc)

    def run():
        for i, img in enumerate(frames):
            if paced:
                system._worker.flush(timeout=120.0)
            system.track_monocular(img, i / 30.0)
        system.shutdown(timeout=60.0)

    with Tracing() as rec:
        _within(DEADLINE_S, run)
    assert system._worker is None
    st = system.tracker.stats
    assert st["resets"] == 0 and st["tracked_frames"] >= N_FRAMES - 4, st
    m = system.map
    kfs = m.keyframe_ids()
    assert len(kfs) >= 3
    est = np.stack([-m.kf_pose[k][:3, :3].T @ m.kf_pose[k][:3, 3] for k in kfs])
    gt = np.stack([-sc.poses[f][:3, :3].T @ sc.poses[f][:3, 3] for f in m.kf_frame_id[kfs]])
    ate = evaluation.ate_rmse(est, gt)[0]
    assert ate < 0.05, ate
    # the schedule ran: overlapped events, deferred BAs, every keyframe in
    # the database after the last BoW landed, nothing left in flight
    assert "wait" in rec.stages("map.")
    assert all(b["deferred"] for b in system.local_mapper.ba_log)
    assert system.loop_closer._pending_bow is None and system.local_mapper._pending_fold is None
    assert int(system.database.present.sum()) == len(kfs)
    assert not system.tracker._inflight


def test_request_reset_mid_run(scene):
    sc, frames = scene
    system = _system(sc)

    def run():
        states = []
        for i, img in enumerate(frames[:14]):
            if i == 7:
                system.request_reset()
            states.append(system.track_monocular(img, i / 30.0))
        system.shutdown(timeout=60.0)
        return states

    states = _within(DEADLINE_S, run)
    assert system.tracker.stats["resets"] == 1
    # the reset dropped the map; the next frames initialized a new one
    assert states[7] == TrackState.NOT_INITIALIZED and states[-1] == TrackState.OK
    assert system.map.n_keyframes() >= 2
    assert int(system.database.present.sum()) == system.map.n_keyframes()


def test_worker_exception_is_raised_on_the_next_frame(scene):
    sc, frames = scene
    system = _system(sc)

    def boom(kf, **kw):
        raise RuntimeError("mapping event failed")

    system.local_mapper.process_keyframe = boom

    def run():
        for i, img in enumerate(frames[:6]):
            system.track_monocular(img, i / 30.0)

    with pytest.raises(RuntimeError, match="mapping event failed"):
        _within(DEADLINE_S, run)
    assert system.map.n_keyframes() >= 2  # the initialization submitted events
    _within(60.0, lambda: system.shutdown(timeout=30.0))
    assert system._worker is None
