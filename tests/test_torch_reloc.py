"""Relocalization of the PyTorch port against the JAX package: a map built
by the JAX System over the first 12 frames of the rendered benchmark
sequence at 320x240 (600 orb32 features), saved by the JAX package and
loaded by the port's System; then one query frame, a view at a mapped
frame's pose, through both trackers' _relocalization. And, on the port
alone (slow), the blackout scenario of tests/test_loop_reloc.py.

Tolerances and why:
- the same relocalization candidates in the same order: the port reads
  the JAX map and computes the same words (tests/test_torch_place_
  recognition.py), and the database code is the same;
- the same outcome, and the relocalized pose within 1e-3 (rotation
  entries and translation, map units of about 2 m): the same matches and
  RANSAC draws, then float32 EPnP and pose LMs in another library;
- one K2 search per candidate in the port.
"""

import numpy as np
import pytest

from anyfeature_vslam_tpu.ops.camera import CameraParams as JaxCamera
from anyfeature_vslam_tpu.slam.tracking import FrameData as JaxFrame
from anyfeature_vslam_tpu.system import System as JaxSystem
from anyfeature_vslam_tpu_torch.io import evaluation
from anyfeature_vslam_tpu_torch.slam import frame_ops
from anyfeature_vslam_tpu_torch.slam.tracking import FrameData, TrackState
from anyfeature_vslam_tpu_torch.system import System
from torch_slice_scene import SliceScene

W, H, N_FEATURES = 320, 240, 600
N_MAP = 12
QUERY = 6  # the query frame re-renders this mapped frame's view


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    sc = SliceScene(W, H)
    jsys = JaxSystem(JaxCamera.create(**sc.camera), feature="orb32", n_features=N_FEATURES,
                     async_mapping=False, use_mesh=False)
    for i in range(N_MAP):
        jsys.track_monocular(sc.render(i)[0], i / 30.0)
    path = str(tmp_path_factory.mktemp("reloc") / "jax_map.npz")
    jsys.save_checkpoint(path)
    tsys = System(JaxCamera.create(**sc.camera), feature="orb32", n_features=N_FEATURES,
                  async_mapping=False, device="cpu")
    tsys.load_checkpoint(path)
    return sc, jsys, tsys


def test_relocalization_matches_jax(systems, monkeypatch):
    sc, jsys, tsys = systems
    assert tsys.map.n_keyframes() == jsys.map.n_keyframes() > 5
    img = sc.render(QUERY)[0]
    jf = JaxFrame(100, 100 / 30.0, jsys.tracker._extract(img, init=False))
    tf = FrameData(100, 100 / 30.0, tsys.tracker._extract(img, init=False))
    want = jsys.database.detect_relocalization_candidates(jf.feats["desc_bits"],
                                                          jf.feats["valid"], jsys.map)
    got = tsys.database.detect_relocalization_candidates(tf.feats.dev("desc_bits"),
                                                         tf.feats.dev("valid"), tsys.map)
    assert got == want and len(got) >= 1
    searches = []
    search = frame_ops.match_descriptors_global
    monkeypatch.setattr(frame_ops, "match_descriptors_global",
                        lambda *a, **kw: searches.append(1) or search(*a, **kw))
    ok_j = jsys.tracker._relocalization(jf)
    ok_t = tsys.tracker._relocalization(tf)
    assert ok_t == ok_j is True
    assert len(searches) == min(len(got), 8)
    np.testing.assert_allclose(tf.pose, jf.pose, atol=1e-3, rtol=0)
    assert abs(tsys.tracker.n_inliers - jsys.tracker.n_inliers) <= 0.05 * jsys.tracker.n_inliers
    # the camera centre is the mapped frame's (keyframes aligned to truth)
    m = tsys.map
    kfs = m.keyframe_ids()
    c_map = np.stack([-m.kf_pose[k][:3, :3].T @ m.kf_pose[k][:3, 3] for k in kfs])
    c_gt = np.stack([-sc.poses[f][:3, :3].T @ sc.poses[f][:3, 3] for f in m.kf_frame_id[kfs]])
    s, r, t = evaluation.umeyama_alignment(c_map, c_gt)
    est = -tf.pose[:3, :3].T @ tf.pose[:3, 3]
    gt = -sc.poses[QUERY][:3, :3].T @ sc.poses[QUERY][:3, 3]
    assert np.linalg.norm(s * r @ est + t - gt) < 0.05


@pytest.mark.slow
def test_port_relocalizes_after_blackout():
    """The port alone: 24 frames mapped, 3 featureless frames (LOST), then
    views at mapped poses: OK within 3 frames, one relocalization."""
    sc = SliceScene(W, H)
    sys_ = System(JaxCamera.create(**sc.camera), n_features=N_FEATURES, async_mapping=False,
                  device="cpu")
    t = 0
    for i in range(24):
        sys_.track_monocular(sc.render(i)[0], t / 30.0)
        t += 1
    assert sys_.tracker.state == TrackState.OK
    for _ in range(3):
        sys_.track_monocular(np.full((H, W), 25, np.uint8), t / 30.0)
        t += 1
    assert sys_.tracker.state == TrackState.LOST
    for f in (10, 11, 12):
        state = sys_.track_monocular(sc.render(f)[0], t / 30.0)
        t += 1
        if state == TrackState.OK:
            break
    assert state == TrackState.OK and sys_.tracker.stats["relocalizations"] >= 1
