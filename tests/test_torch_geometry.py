"""Geometry of the PyTorch port against the JAX package: se3, camera,
pose prediction. Inputs are numpy arrays from a seed, fed to both.

Tolerances: float32 on both sides with other operation orders and
transcendental implementations; 1e-5 absolute on unit-scale matrices
(~100 float32 ulps), 2e-3 px on undistorted pixels (10 fixed-point
iterations at ~600 px scale).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu.ops import camera as jcam
from anyfeature_vslam_tpu.ops import se3 as jse3
from anyfeature_vslam_tpu.slam import fast_track as jtrack
from anyfeature_vslam_tpu_torch import convert
from anyfeature_vslam_tpu_torch.ops import camera as tcam
from anyfeature_vslam_tpu_torch.ops import se3 as tse3
from anyfeature_vslam_tpu_torch.slam import fast_track as ttrack


def _tangents(seed):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.5, (64, 6)).astype(np.float32)
    xi[:8, 3:] *= 1e-5  # small-angle (Taylor) branch
    xi[8:12, 3:] = 0.0
    return xi


@pytest.mark.parametrize("fn", ["hat", "so3_exp", "se3_exp"])
def test_se3_maps_match_jax(fn):
    xi = _tangents(0)
    arg = xi[:, 3:] if fn in ("hat", "so3_exp") else xi
    want = np.asarray(getattr(jse3, fn)(jnp.asarray(arg)))
    got = getattr(tse3, fn)(torch.from_numpy(arg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_se3_inverse_and_rt_to_mat_match_jax():
    t = np.asarray(jse3.se3_exp(jnp.asarray(_tangents(1))))
    np.testing.assert_allclose(tse3.se3_inverse(torch.from_numpy(t)).numpy(),
                               np.asarray(jse3.se3_inverse(jnp.asarray(t))), atol=1e-5, rtol=0)
    r, tr = t[:, :3, :3], t[:, :3, 3]
    np.testing.assert_array_equal(tse3.rt_to_mat(torch.from_numpy(r), torch.from_numpy(tr)).numpy(),
                                  np.asarray(jse3.rt_to_mat(jnp.asarray(r), jnp.asarray(tr))))


def _cameras():
    return [
        dict(fx=520.0, fy=520.0, cx=320.0, cy=240.0),
        dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, k1=0.2624, k2=-0.9531,
             p1=-0.0054, p2=0.0026, k3=1.1633),
    ]


@pytest.mark.parametrize("cam_kw", _cameras())
def test_undistort_points_and_bounds_match_jax(cam_kw):
    rng = np.random.default_rng(2)
    uv = rng.uniform([0, 0], [640, 480], (500, 2)).astype(np.float32)
    jc = jcam.CameraParams.create(**cam_kw)
    tc = convert.camera_from_numpy(jc, "cpu")
    want = np.asarray(jcam.undistort_points(jc, jnp.asarray(uv)))
    got = tcam.undistort_points(tc, torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    np.testing.assert_allclose([float(b) for b in tcam.undistorted_bounds(tc)],
                               [float(b) for b in jcam.undistorted_bounds(jc)], atol=2e-3)


def test_predict_pose_matches_jax():
    t = np.asarray(jse3.se3_exp(jnp.asarray(_tangents(3) * 0.2)))
    for a, b in zip(t[0::2], t[1::2]):
        want = np.asarray(jtrack.predict_pose(jnp.asarray(a), jnp.asarray(b)))
        got = ttrack.predict_pose(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_predict_pose_keeps_a_pipelined_chain_on_so3():
    """The pipelined tracker predicts each frame from the two previous
    dispatches' poses, each the pose LM's update of the prediction before
    it. Along such a chain (a fixed small motion, a pose-LM-like update, 20
    frames) started 1e-6 off SO(3), the JAX function's R^T inverse grows
    the distance by 1 + sqrt(2) per frame to a scaled rotation; the port
    projects the prediction back and stays within float32 rounding (1e-5)."""
    step = np.asarray(jse3.se3_exp(jnp.asarray(np.array([[0.01, 0.0, 0.002, 0.0, 0.003, 0.0]],
                                                        np.float32))))[0]
    update = np.asarray(jse3.se3_exp(jnp.asarray(np.array([[1e-4, -2e-4, 1e-4, 2e-4, 1e-4,
                                                            -1e-4]], np.float32))))[0]
    prev = np.eye(4, dtype=np.float32)
    last = step @ prev
    last[:3, :3] *= np.float32(1.0 + 1e-6)

    def off_so3(p):
        sv = np.linalg.svd(np.asarray(p, np.float64)[:3, :3], compute_uv=False)
        return float(np.abs(sv - 1.0).max())

    jp, jl = jnp.asarray(prev), jnp.asarray(last)
    tp, tl = torch.from_numpy(prev), torch.from_numpy(last)
    rp, rl = prev.astype(np.float64), step.astype(np.float64)  # the exact chain
    for _ in range(20):
        jp, jl = jl, jnp.asarray(update) @ jtrack.predict_pose(jl, jp)
        tp, tl = tl, torch.from_numpy(update) @ ttrack.predict_pose(tl, tp)
        rp, rl = rl, update @ (rl @ np.linalg.inv(rp)) @ rl
    assert off_so3(tl.numpy()) < 1e-5
    assert off_so3(np.asarray(jl)) > 1e-2
    # the port's chain still follows the motion
    np.testing.assert_allclose(tl.numpy(), rl, atol=1e-4, rtol=0)


def test_project_and_k_matrix_match_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform([-2, -2, -1], [2, 2, 9], (200, 3)).astype(np.float32)
    pts[:3, 2] = [0.0, 1e-12, -1e-12]  # the clamped depths
    args = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, k1=0.26, k2=-0.95, p1=0.0, p2=0.0,
                k3=1.16)
    jc, tc = jcam.CameraParams.create(**args), tcam.CameraParams.create(**args, device="cpu")
    np.testing.assert_array_equal(tc.k_matrix.numpy(), np.asarray(jc.k_matrix))
    juv, jz = jcam.project(jc, jnp.asarray(pts))
    tuv, tz = tcam.project(tc, torch.from_numpy(pts))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=1e-6)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
