"""Stereo tracking and monocular localization mode of the PyTorch port (on
the CPU), on tests/test_rgbd_stereo.py's scene, poses and BF at 320x240
with 1000 orb32 features.

Tolerances and why:
- the stereo row search and its sub-pixel refinement against the JAX
  package on one frame pair's features, given to both: match indices and
  validity equal (integer Hamming distances; argmin takes the first
  minimum and round goes half to even in both), disparities within 1e-4
  px (the 11x11 SAD windows are float32 sums taken in other orders, and
  the parabola fit divides their differences);
- the port's stereo System over 12 frames: test_rgbd_stereo.py's
  test_stereo_e2e gates (at least 1 keyframe, >= 70% of frames tracked,
  0 lost), and K1's plain twin never counted as a launch on the CPU;
- localization mode on a synchronous monocular orb32 System over the
  rendered benchmark scene's first 12 frames (tests/torch_slice_scene.py,
  600 features: it initializes and mints keyframes there), its last 8
  frames retraced backwards: every frame tracked, the map's keyframe and
  point counts unchanged, only_tracking set and cleared at the next frame.
Torch and every BLAS pool are held to one thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from anyfeature_vslam_tpu.ops.camera import CameraParams as JaxCamera
from anyfeature_vslam_tpu.slam import frame_ops as jfo
from anyfeature_vslam_tpu_torch.frontend import cuda_fast
from anyfeature_vslam_tpu_torch.frontend.extractor import ExtractorConfig, make_extractor
from anyfeature_vslam_tpu_torch.slam import frame_ops as tfo
from anyfeature_vslam_tpu_torch.system import System
from torch_plane_scene import BASELINE, line_traj, plane_intrinsics, plane_scene, right_view
from torch_slice_scene import SliceScene

W, H = 320, 240
FX, CX, CY = plane_intrinsics(W, H)
BF = FX * BASELINE
N_FEATURES = 1000
N_STEREO = 12
MONO_W, MONO_H, MONO_FEATURES, N_MONO = 320, 240, 600, 12
N_RETRACE = 8


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
def pair(scene):
    """One rectified pair, its rendered depth and both images' features
    (the port's extractor; numpy)."""
    pose = line_traj(2)[0]
    img_l, depth = scene.render_with_depth(pose)
    img_r = right_view(scene, pose)
    ext = make_extractor(ExtractorConfig(n_features=N_FEATURES), H, W)
    fl, fr = ({k: v.numpy() for k, v in ext(torch.from_numpy(im)).items()}
              for im in (img_l, img_r))
    return img_l, img_r, depth, fl, fr


KEYS = ("desc_bits", "xy", "size", "valid")


@pytest.mark.parametrize("subpix", [False, True])
def test_stereo_row_matchers_match_jax(pair, subpix):
    img_l, img_r, depth, fl, fr = pair
    images = (img_l, img_r) if subpix else ()
    name = "match_stereo_rows_subpix" if subpix else "match_stereo_rows"
    want = getattr(jfo, name)(*(jnp.asarray(a) for a in images),
                              *(jnp.asarray(fl[k]) for k in KEYS),
                              *(jnp.asarray(fr[k]) for k in KEYS), 75.0, 0.0, FX)
    got = getattr(tfo, name)(*(torch.from_numpy(a) for a in images),
                             *(torch.from_numpy(fl[k]) for k in KEYS),
                             *(torch.from_numpy(fr[k]) for k in KEYS), 75.0, 0.0, FX)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["idx"], want["idx"])
    np.testing.assert_array_equal(got["dist"], want["dist"])
    np.testing.assert_allclose(got["disparity"], want["disparity"], atol=1e-4, rtol=0)
    # test_rgbd_stereo.py's gate: the disparities reproduce the rendered depth
    ok = got["valid"] & (got["disparity"] > 0)
    assert ok.sum() > 150
    xy = fl["xy"][ok]
    z_gt = depth[np.clip(np.rint(xy[:, 1]).astype(int), 0, H - 1),
                 np.clip(np.rint(xy[:, 0]).astype(int), 0, W - 1)]
    assert np.median(np.abs(BF / got["disparity"][ok] - z_gt) / z_gt) < 0.08


def test_stereo_system(scene):
    """track_stereo over 12 frames: the instant map from the stereo depth,
    then the staged tracker with depth-minted keyframes."""
    cam = JaxCamera.create(fx=FX, fy=FX, cx=CX, cy=CY, width=W, height=H)
    system = System(cam, n_features=N_FEATURES, sensor="stereo", bf=BF, async_mapping=False,
                    device="cpu")
    assert system.tracker.cfg.th_depth == pytest.approx(35.0 * BASELINE)
    with pytest.raises(RuntimeError, match="sensor is stereo"):
        system.track_rgbd(np.zeros((H, W), np.float32), np.ones((H, W), np.float32), 0.0)
    n_k1 = cuda_fast.fast_nms.launches
    for i, p in enumerate(line_traj(N_STEREO)):
        system.track_stereo(scene.render(p), right_view(scene, p), i / 30.0)
        if i == 0:
            kf = int(system.map.keyframe_ids()[0])
            assert int((system.map.kf_depth[kf] > 0).sum()) > 300
    stats = system.tracker.stats
    assert system.map.n_keyframes() >= 1
    assert stats["tracked_frames"] >= 0.7 * N_STEREO, stats
    assert stats["lost_frames"] == 0 and stats["resets"] == 0, stats
    assert cuda_fast.fast_nms.launches == n_k1  # the plain twin on the CPU


def test_monocular_localization_mode():
    sc = SliceScene(MONO_W, MONO_H)
    frames = [sc.render(i)[0] for i in range(N_MONO)]
    system = System(JaxCamera.create(**sc.camera), feature="orb32", n_features=MONO_FEATURES,
                    enable_loop_closing=False, async_mapping=False, device="cpu")
    for i, img in enumerate(frames):
        system.track_monocular(img, i / 30.0)
    stats = dict(system.tracker.stats)
    assert stats["lost_frames"] == 0 and system.tracker.state.name == "OK", stats
    n_kf, n_pt = system.map.n_keyframes(), system.map.n_points()
    assert n_kf >= 3
    system.activate_localization_mode()
    for j, img in enumerate(reversed(frames[-N_RETRACE:])):
        assert system.track_monocular(img, 1.0 + j / 30.0).name == "OK", j
        assert system.tracker.only_tracking and not system.tracker.mb_vo
    assert (system.map.n_keyframes(), system.map.n_points()) == (n_kf, n_pt)
    assert system.tracker.stats["lost_frames"] == 0
    system.deactivate_localization_mode()
    system.track_monocular(frames[-N_RETRACE], 2.0)
    assert not system.tracker.only_tracking
