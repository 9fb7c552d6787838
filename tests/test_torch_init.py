"""Monocular bootstrap of the PyTorch port against the JAX package: the
two-view initializer (on the scenes of tests/test_initializer.py), DLT and
linear triangulation, the initialization search and the triangulation
search with its neighbour loop (on two rendered 320x240 frames of the
benchmark scene, JAX features and ground-truth poses).

Tolerances and why:
- initializer: success, model choice (H or F) and the triangulated-point
  mask equal; the chosen motion within 1e-3 (rotation, rad) and 1e-3
  (unit translation); points within 1e-3 relative. The draws are JAX's
  own (``jax.random.uniform``), passed in, and equal to the port's
  default draws bit for bit;
- triangulation: 1e-4 relative (float32, other summation order);
- the searches: indices and masks exactly equal (integer Hamming
  distances, the same tie order); new points within 5e-3 m (about 2e-3
  of their depth): the linear triangulation solves 3x3 normal equations,
  which square the DLT system's condition number, in float32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu.frontend import extractor as jext
from anyfeature_vslam_tpu.ops import camera as jcam
from anyfeature_vslam_tpu.ops import initializer as jinit
from anyfeature_vslam_tpu.ops import triangulation as jtri
from anyfeature_vslam_tpu.slam import frame_ops as jframe
from anyfeature_vslam_tpu_torch.ops import initializer as tinit
from anyfeature_vslam_tpu_torch.ops import rng as trng
from anyfeature_vslam_tpu_torch.ops import triangulation as ttri
from anyfeature_vslam_tpu_torch.slam import frame_ops as tframe
from test_initializer import K, make_scene
from torch_slice_scene import SliceScene

T = torch.from_numpy


def _init_both(uv1, uv2, valid, seed=0):
    want = {k: np.asarray(v) for k, v in jinit.initialize_two_view(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), jnp.asarray(K), seed).items()}
    draws = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (tinit.N_HYP, len(uv1))))
    got = {k: v.numpy() for k, v in tinit.initialize_two_view(
        T(uv1), T(uv2), T(valid), T(K), seed, draws=T(draws)).items()}
    return want, got


@pytest.mark.parametrize("case", ["general", "planar", "outliers", "rotation_only", "few"])
def test_initializer_matches_jax(case):
    if case == "rotation_only":
        t21, pts, uv1, _, valid = make_scene(seed=3)
        r = np.asarray(jax.scipy.linalg.expm(jnp.asarray(
            [[0, -0.01, -0.05], [0.01, 0, 0.0], [0.05, 0.0, 0]], jnp.float32)))
        pc = pts @ r.T
        uv2 = np.stack([500 * pc[:, 0] / pc[:, 2] + 320, 500 * pc[:, 1] / pc[:, 2] + 240],
                       -1).astype(np.float32)
    else:
        kw = dict(general={}, planar=dict(planar=True, seed=1), outliers=dict(outliers=60, seed=2),
                  few={})[case]
        t21, pts, uv1, uv2, valid = make_scene(**kw)
        if case == "few":
            valid = valid.copy()
            valid[30:] = False
    want, got = _init_both(uv1, uv2, valid)
    for k in ("success", "used_homography", "good", "n_good", "n_inliers"):
        assert np.array_equal(got[k], want[k]), k
    if want["success"]:
        tj, tt = want["t21"], got["t21"]
        assert np.abs(tt[:3, :3] - tj[:3, :3]).max() < 1e-3
        assert np.abs(tt[:3, 3] - tj[:3, 3]).max() < 1e-3
        g = want["good"]
        np.testing.assert_allclose(got["pts3d"][g], want["pts3d"][g], rtol=1e-3, atol=1e-3)
        assert abs(float(got["parallax_deg"]) - float(want["parallax_deg"])) < 1e-2
    assert abs(float(got["rh"]) - float(want["rh"])) < 1e-3


def test_default_draws_are_jax_draws():
    for seed, n in ((0, 300), (5, 1999)):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (tinit.N_HYP, n)))
        assert np.array_equal(trng.uniform(seed, (tinit.N_HYP, n)).view(np.uint32),
                              want.view(np.uint32))
        valid = np.random.default_rng(seed).random(n) < 0.7
        sets_j = np.asarray(jinit._sample_sets(jax.random.PRNGKey(seed), jnp.asarray(valid)))
        sets_t = tinit.sample_sets(T(want), T(valid)).numpy()
        assert np.array_equal(sets_t, sets_j)


def test_triangulation_matches_jax():
    rng = np.random.default_rng(0)
    n = 200
    pts = rng.uniform([-2, -2, 4], [2, 2, 9], (n, 3)).astype(np.float32)
    t2 = np.eye(4, dtype=np.float32)
    t2[:3, 3] = [0.4, 0.05, -0.02]
    p1 = (K @ np.eye(4, dtype=np.float32)[:3]).astype(np.float32)
    p2 = (K @ t2[:3]).astype(np.float32)

    def proj(p, x):
        h = x @ p[:, :3].T + p[:, 3]
        return (h[:, :2] / h[:, 2:] + rng.normal(0, 0.3, (n, 2))).astype(np.float32)

    uv1, uv2 = proj(p1, pts), proj(p2, pts)
    for jf, tf in ((jtri.triangulate_dlt, ttri.triangulate_dlt),
                   (jtri.triangulate_linear3, ttri.triangulate_linear3)):
        want = np.asarray(jf(*map(jnp.asarray, (p1, p2, uv1, uv2))))
        got = tf(*map(T, (p1, p2, uv1, uv2))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    want = np.asarray(jtri.parallax_cos(jnp.asarray(pts), jnp.zeros(3), jnp.asarray(t2[:3, 3])))
    got = ttri.parallax_cos(T(pts), torch.zeros(3), T(t2[:3, 3])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    e_j, z_j = jtri.reprojection_error_sq(500.0, 500.0, 320.0, 240.0, jnp.asarray(t2),
                                          jnp.asarray(pts), jnp.asarray(uv2))
    e_t, z_t = ttri.reprojection_error_sq(500.0, 500.0, 320.0, 240.0, T(t2), T(pts), T(uv2))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6)


# --------------------------------------------- searches on rendered frames

H, W = 240, 320


@pytest.fixture(scope="module")
def frames():
    """JAX features of frames 0, 2 and 4 (2x budget for the init search)
    and their ground-truth poses."""
    sc = SliceScene(W, H)
    jc = jcam.CameraParams.create(**sc.camera)
    out = {}
    for n_feat in (600, 1200):
        cfg = jext.ExtractorConfig(n_features=n_feat)
        for i in (0, 2, 4):
            f = dict(jext.extract_features(jnp.asarray(sc.render(i)[0], jnp.float32), cfg, H, W))
            f["uv_und"] = jcam.undistort_points(jc, f["xy"])
            out[(n_feat, i)] = {k: np.asarray(v) for k, v in f.items()}
    return sc, out


def _dicts_equal(got, want):
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_init_search_matches_jax(frames):
    sc, f = frames
    a, b = f[(1200, 0)], f[(1200, 2)]
    keys = ("uv_und", "desc_bits", "octave", "angle", "valid")
    want = jframe.match_for_initialization(*(jnp.asarray(a[k]) for k in keys),
                                           *(jnp.asarray(b[k]) for k in keys), 100.0, 75.0, 0.9)
    got = tframe.match_for_initialization(*(T(a[k]) for k in keys), *(T(b[k]) for k in keys),
                                          100.0, 75.0, 0.9)
    _dicts_equal(got, want)
    assert int(got["valid"].sum()) > 100


def test_triangulation_search_and_neighbors_match_jax(frames):
    sc, f = frames
    cur = f[(600, 4)]
    nbrs = [f[(600, 0)], f[(600, 2)]]
    k = sc.k.astype(np.float32)
    t1 = sc.poses[4].astype(np.float32)
    t2s = np.stack([sc.poses[0], sc.poses[2]]).astype(np.float32)
    unmatched1 = cur["valid"].copy()
    want = jframe.triangulate_with_neighbors(
        jnp.asarray(cur["desc_bits"]), jnp.asarray(cur["uv_und"]), jnp.asarray(unmatched1),
        jnp.asarray(cur["inv_sigma2"]), jnp.asarray(cur["size"]),
        tuple(jnp.asarray(g["desc_bits"]) for g in nbrs),
        tuple(jnp.asarray(g["uv_und"]) for g in nbrs),
        jnp.asarray(np.stack([g["valid"] for g in nbrs])),
        tuple(jnp.asarray(g["size"]) for g in nbrs),
        tuple(jnp.asarray(g["inv_sigma2"]) for g in nbrs),
        jnp.asarray(t1), jnp.asarray(t2s), jnp.asarray(k), jnp.ones(2, bool), 75.0, 0.6)
    got = tframe.triangulate_with_neighbors(
        T(cur["desc_bits"]), T(cur["uv_und"]), T(unmatched1), T(cur["inv_sigma2"]),
        T(cur["size"]), [T(g["desc_bits"]) for g in nbrs], [T(g["uv_und"]) for g in nbrs],
        [T(g["valid"]) for g in nbrs], [T(g["size"]) for g in nbrs],
        [T(g["inv_sigma2"]) for g in nbrs], T(t1), T(t2s), T(k), 75.0, 0.6)
    idx_j, pts_j, good_j = (np.asarray(x) for x in want)
    idx_t, pts_t, good_t = (x.numpy() for x in got)
    assert np.array_equal(good_t, good_j) and good_j.sum() > 50
    assert np.array_equal(idx_t[good_j], idx_j[good_j])
    assert np.abs(pts_t[good_j] - pts_j[good_j]).max() < 5e-3
    # the second neighbour sees only keypoints the first did not claim
    assert not (good_t[0] & good_t[1]).any()

    # one epipolar search on its own
    f12, ep = tframe._f12_and_epipole(T(t1), T(t2s[0]), T(k), torch.linalg.inv(T(k)))
    g = nbrs[0]
    want = jframe.match_for_triangulation(
        jnp.asarray(cur["desc_bits"]), jnp.asarray(cur["uv_und"]), jnp.asarray(unmatched1),
        jnp.asarray(cur["inv_sigma2"]), jnp.asarray(g["desc_bits"]), jnp.asarray(g["uv_und"]),
        jnp.asarray(g["valid"]), jnp.asarray(g["size"] ** 2), jnp.asarray(f12.numpy()),
        jnp.asarray(ep.numpy()), 75.0, 0.6)
    got = tframe.match_for_triangulation(
        T(cur["desc_bits"]), T(cur["uv_und"]), T(unmatched1), T(g["desc_bits"]),
        T(g["uv_und"]), T(g["valid"]), T(g["size"] ** 2), f12, ep, 75.0, 0.6)
    _dicts_equal(got, want)
