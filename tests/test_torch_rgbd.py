"""RGB-D tracking and localization mode of the PyTorch port against the JAX
package, on tests/test_rgbd_stereo.py's scene, poses and BF at 320x240
with 1000 orb32 features (the port on the CPU).

Tolerances and why:
- the instant initialization (the depth sampled at the keypoints, the
  virtual right coordinate, the keyframe, the points) is held exactly on
  one set of features given to both packages' trackers: keypoints, the
  slots given depth and the point ids equal, point positions within 1e-5
  m (float32 unprojection). Through the Systems the extractions differ in
  a few level-1 keypoints (JAX's pyramid is resized in bf16x3 products,
  the port's in fp32: tests/test_torch_frontend.py), so there the same
  frame initializes with the same number of points and >= 99% of the
  keypoints in both;
- the synchronous RGB-D Systems after 12 frames: keyframe and point
  counts within 25%, keyframe and frame camera centres within 1e-2 m
  without alignment (RGB-D is metric), as tests/test_torch_system.py's
  bounds (float32 pose LMs summed in other orders);
- the port's own 40-frame run meets test_rgbd_stereo.py's gates (0 lost,
  >= 39 tracked, metric scale within 12%, every keyframe with more than
  100 matches); in localization mode a retrace of its last 8 frames
  backwards, then a leg out beyond the map and back, keep every frame
  tracked and the map's counts unchanged: out of the map's view the
  tracker rides its depth points (mb_vo) and relocalizes on the way
  back;
- the TUM RGB-D loaders equal JAX's; run_mono sensor:rgbd runs on them.
The JAX System runs once (a fixture) and stops at 12 frames; the port's
run goes on to 40. Torch and every BLAS pool are held to one thread.
"""

import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from anyfeature_vslam_tpu.io import dataset as jds
from anyfeature_vslam_tpu.ops.camera import CameraParams as JaxCamera
from anyfeature_vslam_tpu.slam import tracking as jtracking
from anyfeature_vslam_tpu.system import System as JaxSystem
from anyfeature_vslam_tpu_torch import run_mono
from anyfeature_vslam_tpu_torch.io import dataset as tds
from anyfeature_vslam_tpu_torch.slam import tracking as ttracking
from anyfeature_vslam_tpu_torch.system import System
from torch_plane_scene import BASELINE, line_traj, out_and_back, plane_intrinsics, plane_scene

W, H = 320, 240
FX, CX, CY = plane_intrinsics(W, H)
BF = FX * BASELINE
N_FEATURES = 1000
N_PARITY = 12
N_RUN = 40
N_RETRACE = 8
N_CLI = 6


def camera():
    return JaxCamera.create(fx=FX, fy=FX, cx=CX, cy=CY, width=W, height=H)


def make_systems(sensor="rgbd"):
    kw = dict(n_features=N_FEATURES, sensor=sensor, bf=BF, async_mapping=False,
              enable_loop_closing=False)
    return (JaxSystem(camera(), use_mesh=False, **kw), System(camera(), device="cpu", **kw))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return plane_scene(W, H)


@pytest.fixture(scope="module")
def poses():
    return line_traj(N_RUN, x1=3.2)


@pytest.fixture(scope="module")
def frames(scene, poses):
    return [scene.render_with_depth(p) for p in poses]


def _centres(system):
    """Camera centres of the keyframes (by frame id) and of every tracked
    frame."""
    m = system.map
    kfs = {int(m.kf_frame_id[k]): _centre(m.kf_pose[k]) for k in m.keyframe_ids()}
    fr = [_centre(m.resolve_anchor(t_cr, uid)) for _, t_cr, uid, _ in system.tracker.trajectory]
    return kfs, np.asarray(fr)


def _centre(t):
    t = np.asarray(t, np.float64)
    return -t[:3, :3].T @ t[:3, 3]


def _snapshot(system, rows):
    m = system.map
    kfs, fr = _centres(system)
    return dict(rows=list(rows), kf_centres=kfs, frame_centres=fr,
                stats=dict(system.tracker.stats),
                kf_frames=[int(m.kf_frame_id[k]) for k in m.keyframe_ids()],
                kf_matched=[int((m.kf_matches[k] >= 0).sum()) for k in m.keyframe_ids()])


@pytest.fixture(scope="module")
def runs(frames):
    """(JAX snapshot after N_PARITY frames, port snapshot after N_PARITY,
    port snapshot after N_RUN, the port System)."""
    jsys, tsys = make_systems()
    jrows, trows, init_xy = [], [], []
    for i, (img, depth) in enumerate(frames[:N_PARITY]):
        for system, rows in ((jsys, jrows), (tsys, trows)):
            state = system.track_rgbd(img, depth, i / 30.0)
            rows.append((state.name, system.map.n_keyframes(), system.map.n_points()))
            if i == 0:
                f = system.tracker.last.feats
                init_xy.append((np.asarray(f["xy"]), np.asarray(f["valid"])))
    jsnap, tsnap12 = _snapshot(jsys, jrows), _snapshot(tsys, trows)
    jsnap["init_xy"], tsnap12["init_xy"] = init_xy
    del jsys
    for i, (img, depth) in enumerate(frames[N_PARITY:], N_PARITY):
        state = tsys.track_rgbd(img, depth, i / 30.0)
        trows.append((state.name, tsys.map.n_keyframes(), tsys.map.n_points()))
    return jsnap, tsnap12, _snapshot(tsys, trows), tsys


def _shared_frames(tsys, scene, pose, fid):
    """One frame's features (the port's extraction) with its depth
    attached, as a (JAX, port) pair of FrameData holding the same values."""
    img, depth = scene.render_with_depth(pose)
    feats = tsys.tracker._extract(img, init=False)
    jf = jtracking.DeviceFeats.from_numpy({k: np.asarray(v) for k, v in feats.items()})
    frames = (jtracking.FrameData(fid, fid / 30.0, jf),
              ttracking.FrameData(fid, fid / 30.0, feats))
    return frames, depth


def _shared_init(scene):
    """Both packages' RGB-D trackers initialized on one frame's features,
    without mapping events (the instant map alone)."""
    jsys, tsys = make_systems()
    frames, depth = _shared_frames(tsys, scene, line_traj(2)[0], 0)
    for system, frame in zip((jsys, tsys), frames):
        system.tracker.on_new_keyframe = None
        system.tracker._attach_depth(frame.feats, depth)
        system.tracker._stereo_initialization(frame)
        assert system.tracker.state.name == "OK"
    return jsys, tsys, frames


def test_instant_initialization_equal(scene):
    """StereoInitialization on one frame's features, given to both
    trackers: the depth at the keypoints, u_right, one keyframe at the
    identity, a point per keypoint with depth."""
    jsys, tsys, (jframe, tframe) = _shared_init(scene)
    jf, feats = jframe.feats, tframe.feats
    jm, tm = jsys.map, tsys.map
    assert jm.n_keyframes() == tm.n_keyframes() == 1
    kf = int(tm.keyframe_ids()[0])
    assert int(jm.keyframe_ids()[0]) == kf
    np.testing.assert_array_equal(tm.kf_uv[kf], jm.kf_uv[kf])
    np.testing.assert_array_equal(tm.kf_depth[kf], jm.kf_depth[kf])
    np.testing.assert_allclose(feats["u_right"], jf["u_right"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm.kf_matches[kf], jm.kf_matches[kf])
    ids = tm.kf_matches[kf][tm.kf_matches[kf] >= 0]
    assert len(ids) > 300 and tm.n_points() == jm.n_points() == len(ids)
    np.testing.assert_allclose(tm.pt_pos[ids], jm.pt_pos[ids], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm.kf_pose[kf], np.eye(4, dtype=np.float32))
    # metric scale: the points lie at the rendered depth (~2 m plane)
    assert 1.5 < np.median(tm.pt_pos[ids][:, 2]) < 2.1


def test_keyframe_decision_and_depth_points_equal(scene, poses):
    """NeedNewKeyFrame's depth-sensor terms (the stereo-weighted reference
    count, need_close, c1c, the 0.4 / 0.75 ratios) and the keyframe's
    depth points, on the same map and frames in both packages: later
    frames with the same features, depth, pose and map matches, decided
    over a sweep of inlier counts with mapping idle and busy, then minted
    as keyframes (equal slots and ids, point positions within 1e-5 m).
    The map matches straddle minTrackedClose (100); the second frame
    lowers th_depth below the ground plane's 2 m (both packages alike), so
    only the platforms are close and the depth points stop after the
    100 nearest."""
    jsys, tsys, _ = _shared_init(scene)
    rng = np.random.default_rng(0)
    decisions = []
    for fid, n_match, th_depth in ((8, 95, None), (20, 105, 1.95)):
        (jframe, tframe), depth = _shared_frames(tsys, scene, poses[fid], fid)
        pts = np.nonzero(tsys.map.pt_valid)[0]
        if th_depth is not None:
            jsys.tracker.cfg.th_depth = tsys.tracker.cfg.th_depth = th_depth
        matches = np.full(tsys.map.n_feat, -1, np.int32)
        slots = rng.choice(np.nonzero(np.asarray(tframe.feats["valid"]))[0], n_match, False)
        matches[slots] = rng.choice(pts, n_match, False)
        for system, frame in zip((jsys, tsys), (jframe, tframe)):
            system.tracker._attach_depth(frame.feats, depth)
            frame.pose = np.asarray(poses[fid], np.float32)
            frame.matches = matches.copy()
            system.tracker.on_keyframe_feats = None
        for idle in (True, False):
            for n_in in (10, 16, 40, 100, 200, 300, 400, 600, 800):
                got = []
                for system, frame in zip((jsys, tsys), (jframe, tframe)):
                    system.tracker.mapping_idle = lambda idle=idle: idle
                    system.tracker.n_inliers = n_in
                    got.append(bool(system.tracker._need_new_keyframe(frame)))
                assert got[0] == got[1], (fid, idle, n_in, got)
                decisions.append(got[1])
        for system, frame in zip((jsys, tsys), (jframe, tframe)):
            system.tracker._create_new_keyframe(frame)
        jm, tm = jsys.map, tsys.map
        assert tm.n_keyframes() == jm.n_keyframes() and tm.n_points() == jm.n_points()
        kf = tsys.tracker.ref_kf
        assert jsys.tracker.ref_kf == kf
        np.testing.assert_array_equal(tm.kf_matches[kf], jm.kf_matches[kf])
        np.testing.assert_array_equal(tm.kf_depth[kf], jm.kf_depth[kf])
        new = np.setdiff1d(tm.kf_matches[kf][tm.kf_matches[kf] >= 0], matches)
        assert len(new) > 50
        np.testing.assert_allclose(tm.pt_pos[new], jm.pt_pos[new], atol=1e-5, rtol=0)
    assert any(decisions) and not all(decisions)


@pytest.mark.parametrize("n_map", [400, 5])
def test_localization_motion_model_with_vo_points_equal(scene, poses, n_map):
    """Localization mode's motion model with depth (reference
    UpdateLastFrame's temporal points, TrackWithMotionModel's mbVO): the
    last frame keeps n_map of its map matches and its other keypoints
    with depth join as visual-odometry points. From the same map and
    features both packages give the same matches, VO inliers, mb_vo (map
    inliers < 10) and outcome (> 20 inliers), the poses within 1e-4."""
    jsys, tsys, lasts = _shared_init(scene)
    (jframe, tframe), depth = _shared_frames(tsys, scene, poses[2], 2)
    velocity = (np.asarray(poses[1], np.float64) @ np.linalg.inv(poses[0])).astype(np.float32)
    out = []
    for system, last, frame in zip((jsys, tsys), lasts, (jframe, tframe)):
        tr = system.tracker
        tr.only_tracking = True
        tr.velocity = velocity
        last.matches[np.nonzero(last.matches >= 0)[0][n_map:]] = -1
        tr._attach_depth(frame.feats, depth)
        ok = tr._track_motion_model(frame)
        out.append((ok, tr.mb_vo, frame.matches, frame.vo_valid, frame.pose))
    (jok, jvo, jm, jv, jp), (tok, tvo, tm, tv, tp) = out
    assert (tok, tvo) == (jok, jvo) and tok, out
    assert tvo == (n_map < 10)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 100
    np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)


def test_system_initializes_alike(runs):
    jsnap, tsnap, _, _ = runs
    assert jsnap["rows"][0] == tsnap["rows"][0] == ("OK", 1, tsnap["rows"][0][2])
    assert tsnap["rows"][0][2] > 300
    (jxy, jv), (txy, tv) = jsnap["init_xy"], tsnap["init_xy"]
    np.testing.assert_array_equal(tv, jv)
    # as tests/test_torch_frontend.py: the keypoints as a set (equal
    # scores swap slots where a level-1 keypoint moves)
    kj, kt = set(map(tuple, jxy[jv].tolist())), set(map(tuple, txy[tv].tolist()))
    assert len(kj & kt) >= 0.99 * len(kj), (len(kj & kt), len(kj))


def test_rgbd_systems_agree(runs):
    """The synchronous RGB-D Systems after 12 frames: counts within 25%,
    keyframe and frame centres within 1e-2 m, no alignment."""
    jsnap, tsnap, _, _ = runs
    assert [r[0] for r in tsnap["rows"]] == [r[0] for r in jsnap["rows"]]
    for k in (1, 2):
        assert abs(tsnap["rows"][-1][k] - jsnap["rows"][-1][k]) \
            <= 0.25 * jsnap["rows"][-1][k], (tsnap["rows"][-1], jsnap["rows"][-1])
    common = sorted(set(jsnap["kf_centres"]) & set(tsnap["kf_centres"]))
    assert common and common[0] == 0
    for f in common:
        d = np.linalg.norm(tsnap["kf_centres"][f] - jsnap["kf_centres"][f])
        assert d < 1e-2, (f, d)
    assert tsnap["frame_centres"].shape == jsnap["frame_centres"].shape == (N_PARITY, 3)
    d = np.linalg.norm(tsnap["frame_centres"] - jsnap["frame_centres"], axis=1)
    assert d.max() < 1e-2, d
    assert tsnap["stats"]["lost_frames"] == jsnap["stats"]["lost_frames"] == 0


def test_rgbd_run_gates(runs, poses):
    """test_rgbd_stereo.py's gates on the port's 40 frames: 0 lost, >= 39
    tracked, the keyframes' metric displacement within 12% of the truth,
    every keyframe with more than 100 matches."""
    _, _, snap, _ = runs
    stats = snap["stats"]
    assert stats["lost_frames"] == 0 and stats["resets"] == 0, stats
    assert stats["tracked_frames"] >= N_RUN - 1, stats
    assert len(snap["kf_frames"]) >= 2
    est = np.stack([snap["kf_centres"][f] for f in snap["kf_frames"]])
    gt = np.stack([_centre(poses[f]) for f in snap["kf_frames"]])
    d_est, d_gt = np.linalg.norm(est[-1] - est[0]), np.linalg.norm(gt[-1] - gt[0])
    assert d_gt > 0.5
    assert abs(d_est - d_gt) / d_gt < 0.12, (d_est, d_gt)
    assert min(snap["kf_matched"]) > 100, snap["kf_matched"]


def test_rgbd_localization_mode(runs, frames, poses, scene):
    """Localization mode on the port's run: the last 8 frames retraced
    backwards all track; then out beyond the map, where the map points
    leave the view and the tracker rides its depth points (mb_vo), and
    back, where relocalization at every mb_vo frame ends it; the map keeps
    its keyframes and points, and deactivating clears only_tracking at
    the next frame."""
    _, _, _, system = runs
    tracker = system.tracker
    n_kf, n_pt = system.map.n_keyframes(), system.map.n_points()
    system.activate_localization_mode()
    for j, (img, depth) in enumerate(reversed(frames[-N_RETRACE:])):
        assert system.track_rgbd(img, depth, 2.0 + j / 30.0).name == "OK", j
        assert tracker.only_tracking and not tracker.mb_vo
    reloc0 = tracker.stats["relocalizations"]
    mb_vo = []
    x0 = float(_centre(poses[N_RUN - N_RETRACE])[0])
    for j, pose in enumerate(out_and_back(x0)):
        img, depth = scene.render_with_depth(pose)
        assert system.track_rgbd(img, depth, 3.0 + j / 30.0).name == "OK", j
        mb_vo.append(tracker.mb_vo)
    assert any(mb_vo) and not mb_vo[-1], mb_vo
    assert tracker.stats["relocalizations"] > reloc0
    assert (system.map.n_keyframes(), system.map.n_points()) == (n_kf, n_pt)
    system.deactivate_localization_mode()
    system.track_rgbd(img, depth, 4.0)  # the leg ends at rest: its last view again
    assert not system.tracker.only_tracking


def _write_tum_rgbd(root, scene, poses):
    """A TUM RGB-D layout: calibration.yaml, rgb.txt, depth.txt (its
    stamps 5 ms after the images'), 8-bit gray PNGs and 16-bit depth PNGs
    at 5000 units per metre."""
    from PIL import Image

    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    with open(os.path.join(root, "calibration.yaml"), "w") as f:
        f.write(f"%YAML:1.0\nCamera.fx: {FX}\nCamera.fy: {FX}\nCamera.cx: {CX}\n"
                f"Camera.cy: {CY}\nCamera.w: {W}\nCamera.h: {H}\nCamera.fps: 30.0\n")
    with open(os.path.join(root, "rgb.txt"), "w") as rgb, \
            open(os.path.join(root, "depth.txt"), "w") as dep:
        rgb.write("# timestamp filename\n")
        for i, p in enumerate(poses):
            img, depth = scene.render_with_depth(p)
            ts = 100.0 + i / 30.0
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(root, "rgb", f"{i:04d}.png"))
            Image.fromarray(np.round(np.clip(depth, 0, None) * 5000).astype(np.uint16)).save(
                os.path.join(root, "depth", f"{i:04d}.png"))
            rgb.write(f"{ts:.6f} rgb/{i:04d}.png\n")
            dep.write(f"{ts + 0.005:.6f} depth/{i:04d}.png\n")


def test_rgbd_loaders_and_cli(tmp_path, scene):
    """load_sequence_rgbd and load_depth equal JAX's on a written TUM RGB-D
    layout; run_mono sensor:rgbd bf:... (run_sequence's RGB-D loop) tracks
    its frames on the CPU and writes its outputs."""
    seq = str(tmp_path / "seq")
    _write_tum_rgbd(seq, scene, line_traj(N_CLI, x1=2.15))
    want, got = jds.load_sequence_rgbd(seq), tds.load_sequence_rgbd(seq)
    assert got.timestamps == want.timestamps and got.image_paths == want.image_paths
    assert got.depth_paths == want.depth_paths and got.depth_factor == want.depth_factor
    assert got.fps == want.fps and len(got.depth_paths) == N_CLI
    for k in ("fx", "fy", "cx", "cy", "width", "height"):
        assert float(getattr(got.camera, k)) == float(getattr(want.camera, k)), k
    for path in got.depth_paths[:2]:
        d = tds.load_depth(path, got.depth_factor)
        assert d.dtype == np.float32
        np.testing.assert_array_equal(d, jds.load_depth(path, want.depth_factor))
    np.testing.assert_array_equal(tds._read_tum_listing(os.path.join(seq, "depth.txt"))[0],
                                  jds._read_tum_listing(os.path.join(seq, "depth.txt"))[0])
    out = str(tmp_path / "out")
    assert run_mono.main([f"sequence_path:{seq}", f"exp_folder:{out}", "exp_id:t",
                          "sensor:rgbd", f"bf:{BF}", f"n_features:{N_FEATURES}", "verbose:0",
                          "device:cpu"]) == 0
    stats = dict(line.split(": ", 1) for line in open(os.path.join(out, "t_statistics.yaml"))
                 if ": " in line)
    assert int(stats["tracked_frames"]) == N_CLI and int(stats["lost_frames"]) == 0
    assert os.path.getsize(os.path.join(out, "t_KeyFrameTrajectory.csv")) > 0
