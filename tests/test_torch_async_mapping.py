"""The asynchronous schedules of the PyTorch port against the JAX package,
on the CPU: asynchronous mapping (the deferred local BA), the deferred fold
itself, the deferred global BA of a loop closure, the deferred BoW of the
threaded loop stage, and the pipelined tracker; with the fixes of three
threaded-mode defects the port does not share with the JAX package.

The Systems run the rendered benchmark scene at 320x240 with 600 orb32
features over 12 frames, as tests/test_torch_system.py does. Before each
frame both asynchronous Systems wait for their pending solve's results
(``local_mapper.wait_pending_ready()``), so ``is_idle()`` is true at every
keyframe decision and both runs are deterministic; on the CPU the port's
readiness probe is ready at once anyway.

Tolerances and why:
- Systems: the same initialization frame and initial point count
  (integer outputs of the same matches and draws); keyframe counts equal
  over the first 8 frames, and at the end within one keyframe (10% of
  about 9) with point counts within 10%, since a borderline keyframe
  decision or cull on float results can go either way (the asynchronous
  runs first differ at frame 9, by one keyframe; the synchronous ones at
  frame 8); at least 60% of the JAX run's keyframes minted at the same
  frames, their centres within 1e-2 map units and rotations within 1e-2
  rad; keyframe ATE below 1 cm after Sim3 alignment (the bounds of
  tests/test_torch_system.py, which says why). The pipelined runs: centres
  and rotations within 2e-2, ATE below 1.5 cm. Their frames are tracked
  against a snapshot up to three frames old and predicted from the device
  chain, and the port predicts a reseeded chain over the real frame gap
  and keeps its rotations on SO(3) where the JAX package does not
  (slam/fast_track.py predict_pose, slam/tracking.py _fast_dispatch):
  measured at frame 10 1.31e-2 apart in the centre and 0.0156 rad in
  rotation; ATE 0.93 cm (JAX) and 1.13 cm (port), against 0.71 / 0.53 cm
  and at most 0.62e-2 / 0.0068 rad apart synchronously. These bounds
  still reject a port run whose local BAs leave the map as it was
  (test_pipelined_bounds_reject_a_run_without_local_ba).
- The deferred fold against the synchronous one: exactly equal maps
  (the same solve on the same inputs, written later); nothing in the map
  moves between the dispatch and the fold.
- The deferred global BA: keyframe poses within 2e-2 after the fold and
  the end drift below 0.6 of its value before the closure (the bounds of
  tests/test_torch_loop.py, which says why); the keyframe added during
  the solve keeps its pose relative to its parent to 1e-5 (float32
  products of two poses).
- The deferred BoW: the same closing call in both packages, one
  keyframe after the closing keyframe; the databases equal after
  ``flush_bow`` (word ids exactly, weights to 1e-6: float32 tf-idf).
"""

import copy
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anyfeature_vslam_tpu.ops.camera import CameraParams as JaxCamera
from anyfeature_vslam_tpu.place_recognition import vocab as jvoc
from anyfeature_vslam_tpu.place_recognition.database import KeyFrameDatabase as JaxDb
from anyfeature_vslam_tpu.slam.loop_closing import LoopCloser as JaxCloser
from anyfeature_vslam_tpu.slam.map_state import SlamMap as JaxMap
from anyfeature_vslam_tpu.system import System as JaxSystem
from anyfeature_vslam_tpu_torch import streams
from anyfeature_vslam_tpu_torch.io import evaluation
from anyfeature_vslam_tpu_torch.place_recognition import vocab as tvoc
from anyfeature_vslam_tpu_torch.place_recognition.database import KeyFrameDatabase as PortDb
from anyfeature_vslam_tpu_torch.slam import local_mapping as tlm
from anyfeature_vslam_tpu_torch.slam.loop_closing import LoopCloser as PortCloser
from anyfeature_vslam_tpu_torch.slam.map_state import SlamMap as PortMap
from anyfeature_vslam_tpu_torch.slam.tracking import FrameData
from anyfeature_vslam_tpu_torch.system import System
from loop_map import CAMERA, build_loop_map, end_drift, train_map_vocabulary
from span_trace import Tracing
from torch_slice_scene import SliceScene

W, H, N_FEATURES = 320, 240, 600
N_PARITY = 12
N_EQUAL = 8
PIPELINED_BOUNDS = dict(centre_tol=2e-2, rot_tol=2e-2, max_ate=0.015)
PortMapCpu = functools.partial(PortMap, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the port's runs at this size are launch-bound,
    and more threads only oversubscribe the cores other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(system, frames, wait_ready):
    rows = []
    for i, img in enumerate(frames):
        if wait_ready:
            system.local_mapper.wait_pending_ready()
        state = system.track_monocular(img, i / 30.0)
        rows.append((state.name, system.map.n_keyframes(), system.map.n_points()))
    system.tracker.flush_pipeline()
    m = system.map
    poses = {int(m.kf_frame_id[k]): m.kf_pose[k].copy() for k in m.keyframe_ids()}
    return rows, poses, dict(system.tracker.stats)


def _pair(**kw):
    sc = SliceScene(W, H)
    frames = [sc.render(i)[0] for i in range(N_PARITY)]
    wait = kw.get("async_mapping", True)
    jsys = JaxSystem(JaxCamera.create(**sc.camera), feature="orb32", n_features=N_FEATURES,
                     enable_loop_closing=False, use_mesh=False, **kw)
    tsys = System(JaxCamera.create(**sc.camera), feature="orb32", n_features=N_FEATURES,
                  enable_loop_closing=False, device="cpu", **kw)
    jrun = _run(jsys, frames, wait)
    with Tracing() as rec:
        trun = _run(tsys, frames, wait)
    return jrun, trun, tsys, rec


@pytest.fixture(scope="module")
def async_runs():
    return _pair()


@pytest.fixture(scope="module")
def pipelined_runs():
    return _pair(async_mapping=False, pipeline_depth=2)


def _centre(t):
    t = t.astype(np.float64)
    return -t[:3, :3].T @ t[:3, 3]


def _hold_to_system_bounds(jrun, trun, n_equal, centre_tol=1e-2, rot_tol=1e-2, max_ate=0.01):
    (jrows, jposes, jstats), (trows, tposes, tstats) = jrun, trun
    init_j = next(k for k, r in enumerate(jrows) if r[0] == "OK")
    init_t = next(k for k, r in enumerate(trows) if r[0] == "OK")
    assert (init_t, trows[init_t][2]) == (init_j, jrows[init_j][2])
    assert [r[1] for r in trows[:n_equal]] == [r[1] for r in jrows[:n_equal]], (trows, jrows)
    assert abs(trows[-1][1] - jrows[-1][1]) <= max(1, 0.1 * jrows[-1][1]), (trows, jrows)
    assert abs(trows[-1][2] - jrows[-1][2]) <= 0.1 * jrows[-1][2], (trows[-1], jrows[-1])
    assert tstats["resets"] == jstats["resets"] == 0
    assert tstats["lost_frames"] == jstats["lost_frames"] == 0
    _hold_poses(jposes, tposes, centre_tol, rot_tol, max_ate)


def _hold_poses(jposes, tposes, centre_tol, rot_tol, max_ate):
    common = sorted(set(jposes) & set(tposes))
    assert len(common) >= 0.6 * len(jposes), (sorted(jposes), sorted(tposes))
    for fid in common:
        a, b = tposes[fid].astype(np.float64), jposes[fid].astype(np.float64)
        r = a[:3, :3] @ b[:3, :3].T
        w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
        rot = np.arctan2(0.5 * np.linalg.norm(w), 0.5 * (np.trace(r) - 1))
        assert np.linalg.norm(_centre(a) - _centre(b)) < centre_tol and rot < rot_tol, (fid, rot)
    sc = SliceScene(W, H)
    for poses in (jposes, tposes):
        est = np.stack([_centre(p) for p in poses.values()])
        gt = np.stack([_centre(sc.poses[f]) for f in poses])
        assert evaluation.ate_rmse(est, gt)[0] < max_ate


def test_async_mapping_matches_jax(async_runs):
    jrun, trun, tsys, rec = async_runs
    _hold_to_system_bounds(jrun, trun, N_EQUAL)
    # every local BA after the first events was deferred and folded later
    log = tsys.local_mapper.ba_log
    assert log and all(b["deferred"] for b in log)
    assert rec.stages("map.").get("fold")


def test_pipelined_tracker_matches_jax(pipelined_runs):
    jrun, trun, tsys, _ = pipelined_runs
    _hold_to_system_bounds(jrun, trun, N_EQUAL, **PIPELINED_BOUNDS)
    assert tsys.tracker.pipeline_depth == 2 and not tsys.tracker._inflight


def test_pipelined_bounds_reject_a_run_without_local_ba(pipelined_runs, monkeypatch):
    """The pipelined bounds are looser than the synchronous ones; a port run
    whose local BAs leave the map as it was (poses and points restored
    after each solve; the initial two-keyframe BA kept) must still fail
    them."""
    def dropping(slam_map, intrinsics, free_kfs, fixed_kfs, *a, **kw):
        if len(free_kfs) + len(fixed_kfs) <= 2:
            return run_ba(slam_map, intrinsics, free_kfs, fixed_kfs, *a, **kw)
        saved = slam_map.kf_pose.copy(), slam_map.pt_pos.copy()
        out = run_ba(slam_map, intrinsics, free_kfs, fixed_kfs, *a, **kw)
        slam_map.kf_pose[:], slam_map.pt_pos[:] = saved
        return out

    run_ba = tlm.run_bundle_adjustment
    monkeypatch.setattr(tlm, "run_bundle_adjustment", dropping)
    sc = SliceScene(W, H)
    frames = [sc.render(i)[0] for i in range(N_PARITY)]
    tsys = System(JaxCamera.create(**sc.camera), feature="orb32", n_features=N_FEATURES,
                  enable_loop_closing=False, device="cpu", async_mapping=False,
                  pipeline_depth=2)
    _, tposes, _ = _run(tsys, frames, wait_ready=False)
    with pytest.raises(AssertionError):
        _hold_poses(pipelined_runs[0][1], tposes, **PIPELINED_BOUNDS)


# ------------------------------------------------------ the deferred fold
@pytest.fixture(scope="module")
def snapshot():
    """(port map, recent points, processed count, keyframe) just before the
    last keyframe event of a synchronous port run over 6 frames."""
    sc = SliceScene(W, H)
    system = System(JaxCamera.create(**sc.camera), feature="orb32", n_features=N_FEATURES,
                    async_mapping=False, enable_loop_closing=False, device="cpu")
    snaps = []
    event = system.tracker.on_new_keyframe

    def capture(kf):
        mapper = system.local_mapper
        m = copy.copy(system.map)
        m.__dict__ = {k: copy.deepcopy(v) for k, v in vars(system.map).items()
                      if k not in ("_mirror", "on_kf_removed")}
        m._mirror = None
        m.on_kf_removed = None
        snaps.append((m, dict(mapper.recent), mapper.n_kf_processed, kf))
        event(kf)

    system.tracker.on_new_keyframe = capture
    for i in range(6):
        system.track_monocular(sc.render(i)[0], i / 30.0)
    assert system.tracker.stats["resets"] == 0 and len(snaps) >= 4
    return snaps[-1]


def _mapper(snapshot):
    snap, recent, n_done, kf = snapshot
    m = copy.deepcopy(snap)
    sc = SliceScene(W, H)
    mapper = tlm.LocalMapper(m, (sc.fx, sc.fy, sc.cx, sc.cy), W, H, match_th=75.0,
                             size_tolerance=1.2, device="cpu")
    mapper.recent = dict(recent)
    mapper.n_kf_processed = n_done
    return mapper, m, kf


_STATE = ("kf_valid", "kf_uid", "kf_pose", "kf_matches", "pt_valid", "pt_pos")


def _state(m):
    return {k: getattr(m, k).copy() for k in _STATE}


def test_deferred_fold_equals_synchronous_fold(snapshot):
    sync, m_sync, kf = _mapper(snapshot)
    deferred, m_def, _ = _mapper(snapshot)
    sync.process_keyframe(kf)
    deferred.process_keyframe(kf, defer_ba=True)
    assert deferred._pending_fold is not None and deferred.is_idle()
    before = _state(m_def)
    deferred.wait_pending_ready()
    for k, v in _state(m_def).items():
        assert np.array_equal(v, before[k]), f"{k} moved before the fold"
    deferred.flush_results()
    assert deferred._pending_fold is None
    for k, v in _state(m_sync).items():
        assert np.array_equal(getattr(m_def, k), v), k


def test_deferred_fold_skips_a_recycled_keyframe_slot(snapshot):
    deferred, m, kf = _mapper(snapshot)
    deferred.process_keyframe(kf, defer_ba=True)
    free = [int(k) for k in m.keyframe_ids() if int(m.kf_uid[k]) != 0 and k != kf]
    slot = free[0]
    m.remove_keyframe(slot)
    assert int(np.nonzero(~m.kf_valid)[0][0]) == slot
    feats = dict(uv_und=m.kf_uv[kf].copy(), desc_bits=m.kf_desc_bits[kf].copy(),
                 octave=m.kf_octave[kf].copy(), size=m.kf_size[kf].copy(),
                 angle=m.kf_angle[kf].copy(), inv_sigma2=m.kf_inv_sigma2[kf].copy(),
                 valid=m.kf_feat_valid[kf].copy())
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.3, -0.2, 0.1]
    matches = np.full(m.n_feat, -1, np.int32)
    assert m.add_keyframe(pose, 99.0, 99, feats, matches) == slot
    deferred.flush_results()
    assert np.array_equal(m.kf_pose[slot], pose)
    assert np.array_equal(m.kf_matches[slot], matches)


# ---------------------------------------------------- the deferred global BA
def _closers(jm, tm, **attrs):
    jv = train_map_vocabulary(jm, jvoc.train_vocabulary)
    tv = tvoc.Vocabulary(jv.branching, jv.depth, jv.centroids, jv.idf)
    jc = JaxCloser(jm, JaxCamera.create(**CAMERA), JaxDb(jv, jm.max_kf), match_th=75.0)
    tc = PortCloser(tm, SimpleNamespace(**CAMERA), PortDb(tv, tm.max_kf, "cpu"), match_th=75.0,
                    device="cpu")
    for c in (jc, tc):
        for k, v in attrs.items():
            setattr(c, k, v() if callable(v) else v)
    return jc, tc


def _add_keyframe_during_solve(m, parent):
    """A keyframe created while the global BA runs: the parent's features,
    a pose 5 cm off the parent's, 5 new points referenced to it."""
    feats = dict(uv_und=m.kf_uv[parent].copy(), desc_bits=m.kf_desc_bits[parent].copy(),
                 octave=m.kf_octave[parent].copy(), size=m.kf_size[parent].copy(),
                 angle=m.kf_angle[parent].copy(), inv_sigma2=m.kf_inv_sigma2[parent].copy(),
                 valid=m.kf_feat_valid[parent].copy())
    pose = m.kf_pose[parent].copy()
    pose[:3, 3] += np.float32([0.05, 0.0, 0.01])
    kf = m.add_keyframe(pose, 50.0, 50, feats, np.full(m.n_feat, -1, np.int32))
    m.kf_parent[kf] = parent
    pts = np.float32([[0.1 * i, 0.2, 3.0] for i in range(5)])
    m.add_points(pts, feats["desc_bits"][:5], kf, np.ones(5, np.float32))
    return kf


def test_deferred_global_ba_matches_jax():
    jm, gt_pose = build_loop_map(JaxMap)
    tm, _ = build_loop_map(PortMapCpu)
    n_kf = jm.n_keyframes()
    sinks = ([], [])
    jc, tc = _closers(jm, tm)
    jc.defer_ba_sink, tc.defer_ba_sink = sinks[0].append, sinks[1].append
    before = end_drift(tm, gt_pose, n_kf)
    kf_j = next(kf for kf in range(n_kf) if jc.process_keyframe(kf))
    kf_t = next(kf for kf in range(n_kf) if tc.process_keyframe(kf))
    assert kf_t == kf_j and [len(s) for s in sinks] == [1, 1]
    assert tm.change_idx == 0  # the big change lands with the fold
    new_kfs = [_add_keyframe_during_solve(m, n_kf - 1) for m in (jm, tm)]
    assert new_kfs[0] == new_kfs[1]
    new = new_kfs[1]
    t_rel = tm.kf_pose[new] @ np.linalg.inv(tm.kf_pose[n_kf - 1])
    new_pts = np.nonzero(tm.pt_ref_kf == new)[0]
    x_cam = tm.pt_pos[new_pts] @ tm.kf_pose[new][:3, :3].T + tm.kf_pose[new][:3, 3]
    for sink in sinks:
        sink[0]()
    assert tm.change_idx == 1 and tc.gba_log[0]["deferred"]
    for k in tm.keyframe_ids():
        np.testing.assert_allclose(tm.kf_pose[k], jm.kf_pose[k], atol=2e-2, rtol=0,
                                   err_msg=f"keyframe {k}")
    assert end_drift(tm, gt_pose, n_kf) < 0.6 * before
    # the mid-solve keyframe followed its parent, its points followed it
    np.testing.assert_allclose(tm.kf_pose[new], t_rel @ tm.kf_pose[n_kf - 1], atol=1e-5)
    x_after = tm.pt_pos[new_pts] @ tm.kf_pose[new][:3, :3].T + tm.kf_pose[new][:3, 3]
    np.testing.assert_allclose(x_after, x_cam, atol=1e-4)


# ---------------------------------------------------------- the deferred BoW
def test_deferred_bow_lands_one_keyframe_late():
    jm, _ = build_loop_map(JaxMap)
    tm, _ = build_loop_map(PortMapCpu)
    n_kf = jm.n_keyframes()
    jc, tc = _closers(jm, tm, deferred_bow=True)
    # one call more than keyframes: the last keyframe's detection runs at it
    calls = list(range(n_kf)) + [n_kf - 1]
    closed = [[i for i, kf in enumerate(calls) if c.process_keyframe(kf)] for c in (jc, tc)]
    assert closed[0] == closed[1] and len(closed[1]) == 1
    assert tm.loop_edges == jm.loop_edges and len(tm.loop_edges) == 1
    closing_kf = tm.uid_slot[tm.loop_edges[0][0]]
    assert closed[1][0] == closing_kf + 1
    for c in (jc, tc):
        c.flush_bow()
        assert c._pending_bow is None
    assert np.array_equal(tc.db.present, jc.db.present)
    assert np.array_equal(tc.db.kf_words, jc.db.kf_words)
    np.testing.assert_allclose(tc.db.kf_weights, jc.db.kf_weights, atol=1e-6, rtol=0)


# ------------------------------------------- fixes of threaded-mode defects
def test_stale_sim3_is_not_applied():
    """A Sim3 computed without the lock is dropped when its candidate's slot
    was recycled before the correction (the JAX package applies it)."""
    tm, _ = build_loop_map(PortMapCpu)
    n_kf = tm.n_keyframes()
    _, tc = _closers(build_loop_map(JaxMap)[0], tm)
    compute = tc._compute_sim3

    def compute_then_recycle(kf, cand):
        out = compute(kf, cand)
        if out[0]:
            feats = dict(uv_und=tm.kf_uv[cand].copy(), desc_bits=tm.kf_desc_bits[cand].copy(),
                         octave=tm.kf_octave[cand].copy(), size=tm.kf_size[cand].copy(),
                         angle=tm.kf_angle[cand].copy(),
                         inv_sigma2=tm.kf_inv_sigma2[cand].copy(),
                         valid=tm.kf_feat_valid[cand].copy())
            tm.remove_keyframe(cand)
            assert tm.add_keyframe(tm.kf_pose[cand].copy(), 60.0, 60, feats,
                                   np.full(tm.n_feat, -1, np.int32)) == cand
        return out

    tc._compute_sim3 = compute_then_recycle
    poses = None
    for kf in range(n_kf):
        poses = tm.kf_pose.copy()
        assert not tc.process_keyframe(kf)
    assert tc.n_loops_closed == 0 and tm.loop_edges == [] and not tc.gba_log
    assert tc._pending_merge is None and tc._loop_points is None
    assert np.array_equal(tm.kf_pose[tm.keyframe_ids()], poses[tm.keyframe_ids()])


def _retire_rec(tracker, n_in):
    n = tracker.map.n_feat
    t = [torch.eye(4), torch.full((n,), -1, dtype=torch.int32), torch.tensor(n_in),
         torch.zeros(4, dtype=torch.bool), torch.tensor(True)]
    return dict(frame=FrameData(0, 0.0, None), ready=streams.Ready(t),
                blk_ids_np=np.zeros(4, np.int64), blk_valid_np=np.zeros(4, bool))


def test_weak_frame_budget_holds_across_replays():
    """Three weak frames (18 <= inliers < 30) in a row keep tracking, the
    fourth fails, with a replay of a speculative failure in between (the
    JAX package resets the streak at each replay)."""
    sc = SliceScene(160, 120, n_frames=2)
    system = System(JaxCamera.create(**sc.camera), n_features=200, device="cpu",
                    enable_loop_closing=False, async_mapping=False, pipeline_depth=2)
    tr = system.tracker
    tr._run_state_machine = lambda frame, img: None
    assert tr._fast_retire(_retire_rec(tr, 20), pipelined=False)
    tr._handle_fast_failure(FrameData(1, 0.0, None))
    assert tr._weak_streak == 1 and not tr._draining and tr._chain is None
    assert tr._fast_retire(_retire_rec(tr, 20), pipelined=False)
    assert tr._fast_retire(_retire_rec(tr, 20), pipelined=False)
    assert not tr._fast_retire(_retire_rec(tr, 20), pipelined=False)
    assert tr._fast_retire(_retire_rec(tr, 35), pipelined=False) and tr._weak_streak == 0


@pytest.mark.parametrize("lands_meanwhile", [False, True])
def test_snapshot_clears_only_the_fresh_event_it_saw(lands_meanwhile):
    """The snapshot rebuild clears the fresh-event token it read under the
    lock; a newer event that landed meanwhile stays flagged (the JAX package
    clears whatever is set)."""
    sc = SliceScene(160, 120, n_frames=2)
    system = System(JaxCamera.create(**sc.camera), n_features=200, device="cpu",
                    enable_loop_closing=False, threaded_mapping=True)
    try:
        lm, tr = system.local_mapper, system.tracker
        lm.fresh_event = 3

        def build():
            if lands_meanwhile:
                lm.fresh_event = 4
            return dict(rev=0)

        tr._build_fast_state = build
        assert tr._rebuild_snapshot(7) == dict(rev=0) and tr._fs_built_fid == 7
        assert lm.fresh_event == (4 if lands_meanwhile else 0)
    finally:
        system.shutdown(timeout=30.0)
