"""Bundle adjustment of the PyTorch port against the JAX package, on the
synthetic problems of tests/test_ba.py.

Tolerances and why: both packages run the same LM schedule in float32
with other summation orders, so
- camera poses within 1e-3 (rotation rad, translation) and points within
  1e-3 m after a converged solve;
- the outlier sets of the two-stage schedule equal, but for observations
  whose final chi2 lies within 1e-2 of the 5.991 gate;
- final chi2 within 1e-2 relative or 1e-3 absolute;
- invalid observations exactly inf in both.
Both solver paths (dense Schur and preconditioned CG) are checked; the
dispatch between them follows the padded sizes, as in the JAX package.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu.ops import ba as jba
from anyfeature_vslam_tpu_torch.ops import ba as tba
from test_ba import CX, CY, FX, FY, synth_ba

KEYS = ("obs_kf", "obs_pt", "obs_uv", "obs_w", "obs_valid")


def _args(poses, pts, free, obs, to):
    return (to(poses), to(pts), to(free), *(to(obs[k]) for k in KEYS), FX, FY, CX, CY)


def _close_poses(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() < tol


def _pad_points(pts, n):
    out = np.zeros((n, 3), np.float32)
    out[: len(pts)] = pts
    return out


@pytest.mark.parametrize("seed,n_iters,path", [(0, 15, "dense"), (3, 10, "dense"),
                                               (0, 10, "cg"), (1, 8, "cg")])
def test_bundle_adjust_matches_jax(seed, n_iters, path):
    _, _, poses_n, pts_n, obs = synth_ba(seed=seed)
    free = np.ones(len(poses_n), bool)
    free[0] = False
    if seed == 3:
        rng = np.random.default_rng(8)
        bad = rng.choice(len(obs["obs_kf"]), len(obs["obs_kf"]) // 2, replace=False)
        obs["obs_uv"][bad] += 1000.0
        obs["obs_valid"][bad] = False
    if path == "cg":
        # pad the points past the dense cap: 6 x 400000 cells > 2M
        pts_n = _pad_points(pts_n, 400_000)
    jp, jx, jc, jz = jba.bundle_adjust(*_args(poses_n, pts_n, free, obs, jnp.asarray),
                                       n_iters=n_iters)
    tp, tx, tc, tz = tba.bundle_adjust(*_args(poses_n, pts_n, free, obs, torch.from_numpy),
                                       n_iters=n_iters)
    assert _close_poses(tp.numpy(), jp, 1e-3)
    n = len(np.unique(obs["obs_pt"]))
    assert np.abs(tx.numpy()[:n] - np.asarray(jx)[:n]).max() < 1e-3
    jc, tc = np.asarray(jc), tc.numpy()
    assert np.array_equal(np.isinf(jc), np.isinf(tc))
    fin = np.isfinite(jc)
    assert np.all(np.abs(tc[fin] - jc[fin]) <= np.maximum(1e-2 * jc[fin], 1e-3))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-4)
    # fixed cameras stay put exactly
    np.testing.assert_array_equal(tp.numpy()[0], poses_n[0])


def test_two_stage_matches_jax():
    _, _, poses_n, pts_n, obs = synth_ba(seed=2)
    o = len(obs["obs_kf"])
    out_idx = np.random.default_rng(7).choice(o, o // 10, replace=False)
    obs["obs_uv"][out_idx] += 40.0
    free = np.ones(len(poses_n), bool)
    free[0] = False
    jp, jx, jc, jz, jv = jba.bundle_adjust_two_stage(
        *_args(poses_n, pts_n, free, obs, jnp.asarray), n_iters_a=8, n_iters_b=10)
    tp, tx, tc, tz, tv = tba.bundle_adjust_two_stage(
        *_args(poses_n, pts_n, free, obs, torch.from_numpy), n_iters_a=8, n_iters_b=10)
    assert _close_poses(tp.numpy(), jp, 1e-3)
    j_out = np.asarray(jba.classify_outliers(jc, jz))
    t_out = tba.classify_outliers(tc, tz).numpy()
    near_gate = np.abs(np.asarray(jc) - tba.CHI2_MONO) < 1e-2
    assert np.array_equal(j_out[~near_gate], t_out[~near_gate])
    assert np.array_equal(np.asarray(jv)[~near_gate], tv.numpy()[~near_gate])
    assert t_out[out_idx].mean() > 0.9


def test_constants_match_jax():
    assert (tba.CHI2_MONO, tba.DX_TOL, tba.CG_RTOL2) == (jba.CHI2_MONO, jba.DX_TOL, jba.CG_RTOL2)
    assert (tba._DENSE_MAX_KP, tba._DENSE_MAX_K) == (jba._DENSE_MAX_KP, jba._DENSE_MAX_K)
    assert np.float32(tba.HUBER_DELTA) == np.float32(jba.HUBER_DELTA)
