"""RANSAC-EPnP, Sim3 (Horn, RANSAC, LM), the Sim3 Lie-group helpers and the
essential-graph solver of the PyTorch port against the JAX package, on the
cases of tests/test_pnp_sim3.py and tests/test_pose_graph.py.

Tolerances and why:
- inlier masks and inlier counts exactly equal: both packages draw the
  same RANSAC subsets (ops/rng.py reproduces jax.random.uniform) and the
  hypothesis gates are far from float32 rounding on these problems;
- R, t within 1e-4 and the Sim3 scale within 1e-4: float32 eigh / SVD /
  solve in another library and summation order (eigenvector signs differ,
  the poses they give do not);
- the pose graph's vertices within 1e-4 after 20 LM steps (float32, the
  Jacobians by forward-mode AD in both);
- Sim3 exp / log / compose within 1e-5 (2e-4 for log near the cut locus,
  as the JAX test's round trip).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu.ops import pnp as jpnp
from anyfeature_vslam_tpu.ops import pose_graph as jpg
from anyfeature_vslam_tpu.ops import se3 as jse3
from anyfeature_vslam_tpu.ops import sim3 as jsim3
from anyfeature_vslam_tpu_torch.ops import pnp as tpnp
from anyfeature_vslam_tpu_torch.ops import pose_graph as tpg
from anyfeature_vslam_tpu_torch.ops import se3 as tse3
from anyfeature_vslam_tpu_torch.ops import sim3 as tsim3
from test_pnp_sim3 import CX, CY, FX, FY, make_pnp_problem, make_sim3_problem
from test_pose_graph import make_loop_problem

T = torch.from_numpy


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _tnp(d):
    return {k: v.numpy() for k, v in d.items()}


def _same_pose(a, b, keys=("r", "t"), atol=1e-4):
    for k in keys:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["clean", "outliers", "valid_mask"])
def test_pnp_ransac_matches_jax(case):
    pts, uv, valid = _pnp_case(case)
    sig = np.ones(len(pts), np.float32)
    j = _np(jpnp.pnp_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(sig),
                            jnp.asarray(valid), FX, FY, CX, CY, 0))
    t = _tnp(tpnp.pnp_ransac(T(pts), T(uv), T(sig), T(valid), FX, FY, CX, CY, 0))
    assert int(t["n_inliers"]) == int(j["n_inliers"])
    assert np.array_equal(t["inliers"], j["inliers"])
    _same_pose(t, j)


def _pnp_case(case):
    """The three cases of tests/test_pnp_sim3.py: (pts, uv, valid)."""
    seed = {"clean": 0, "outliers": 1, "valid_mask": 2}[case]
    _, pts, uv = make_pnp_problem(outliers=50 if case == "outliers" else 0, seed=seed)
    valid = np.ones(len(pts), bool)
    if case == "valid_mask":
        uv = uv.copy()
        uv[:60] += 300.0
        valid[:60] = False
    return pts, uv, valid


def test_pnp_ransac_many_matches_jax_vmap():
    """The three cases as three candidates of one batch, as relocalization
    batches its candidate keyframes: the same draws for every candidate
    (the JAX vmap broadcasts the seed)."""
    pts_c, uv_c, valid = (np.stack(a) for a in zip(*(_pnp_case(c) for c in
                                                     ("clean", "outliers", "valid_mask"))))
    sig = np.ones(valid.shape, np.float32)
    j = _np(jpnp.pnp_ransac_many(jnp.asarray(pts_c), jnp.asarray(uv_c), jnp.asarray(sig),
                                 jnp.asarray(valid), FX, FY, CX, CY, 0))
    t = _tnp(tpnp.pnp_ransac_many(T(pts_c), T(uv_c), T(sig), T(valid), FX, FY, CX, CY, 0))
    assert np.array_equal(t["n_inliers"], j["n_inliers"])
    assert np.array_equal(t["inliers"], j["inliers"])
    _same_pose(t, j)


def test_horn_matches_jax():
    _, _, _, pc1, pc2, _, _ = make_sim3_problem()
    w = np.ones(len(pc1), np.float32)
    rj, tj, sj = (np.asarray(x) for x in jsim3.horn_sim3(jnp.asarray(pc2), jnp.asarray(pc1),
                                                          jnp.asarray(w)))
    rt, tt, st = (x.numpy() for x in tsim3.horn_sim3(T(pc2), T(pc1), T(w)))
    np.testing.assert_allclose(rt, rj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tt, tj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(st, sj, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_matches_jax(fix_scale):
    if fix_scale:
        _, _, _, pc1, pc2, uv1, uv2 = make_sim3_problem(s=1.0, seed=2)
    else:
        _, _, _, pc1, pc2, uv1, uv2 = make_sim3_problem(outliers=30, seed=1)
    n = len(pc1)
    ones = np.ones(n, np.float32)
    valid = np.ones(n, bool)
    j = _np(jsim3.sim3_ransac(*(jnp.asarray(a) for a in (pc1, pc2, uv1, uv2, ones, ones, valid)),
                              FX, FY, CX, CY, 0, fix_scale=fix_scale))
    t = _tnp(tsim3.sim3_ransac(*(T(a) for a in (pc1, pc2, uv1, uv2, ones, ones, valid)),
                               FX, FY, CX, CY, 0, fix_scale=fix_scale))
    assert int(t["n_inliers"]) == int(j["n_inliers"])
    assert np.array_equal(t["inliers"], j["inliers"])
    _same_pose(t, j, keys=("r", "t", "s"))


@pytest.mark.parametrize("case", ["ransac_start", "identity_fixed_scale", "identity_outliers"])
def test_sim3_optimize_matches_jax(case):
    """The LM as loop closing runs it (from the RANSAC estimate, 30
    outliers), and the JAX test's two cases from the identity: fixed scale,
    and free scale with 10 gross outliers, which the outlier pass drops.
    The port's second LM stage is the JAX package's as it runs under JAX
    0.9 (its second ``lax.scan`` reuses the first trace: steps scored with
    the weights from before the pass, against the survivors' cost), so R,
    t, s agree within 1e-4 in all three."""
    fx, fy, cx, cy = (FX, FY, CX, CY) if case == "ransac_start" else (300.0, 300.0, 160.0, 120.0)
    if case == "ransac_start":
        _, _, _, pc1, pc2, uv1, uv2 = make_sim3_problem(outliers=30, seed=1)
        n = len(pc1)
    else:
        rng = np.random.default_rng(4 if case == "identity_fixed_scale" else 3)
        n = 60 if case == "identity_fixed_scale" else 100
        pc2 = rng.uniform([-1, -1, 3], [1, 1, 6], (n, 3)).astype(np.float32)
        if case == "identity_fixed_scale":
            pc1 = pc2 + np.array([0.1, 0.05, -0.1], np.float32)
        else:
            ang = 0.2
            r_gt = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                             [0, 0, 1]], np.float32)
            pc1 = (1.3 * pc2 @ r_gt.T + np.array([0.15, -0.05, 0.2], np.float32)).astype(
                np.float32)
        uv1 = np.asarray(jsim3._project(jnp.asarray(pc1), fx, fy, cx, cy)[0]).copy()
        uv2 = np.asarray(jsim3._project(jnp.asarray(pc2), fx, fy, cx, cy)[0])
        if case == "identity_outliers":
            uv1[:10] += 50.0
    ones = np.ones(n, np.float32)
    valid = np.ones(n, bool)
    fix_scale = case == "identity_fixed_scale"
    if case == "ransac_start":
        st = _np(jsim3.sim3_ransac(*(jnp.asarray(a) for a in (pc1, pc2, uv1, uv2, ones, ones,
                                                              valid)), fx, fy, cx, cy, 0))
        start = (st["r"], st["t"], float(st["s"]))
    else:
        start = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0)
    j = _np(jsim3.sim3_optimize(*start, *(jnp.asarray(a) for a in (pc1, pc2, uv1, uv2, ones,
                                                                    ones, valid)),
                                fx, fy, cx, cy, fix_scale=fix_scale))
    t = _tnp(tsim3.sim3_optimize(*start, *(T(a) for a in (pc1, pc2, uv1, uv2, ones, ones,
                                                          valid)),
                                 fx, fy, cx, cy, fix_scale=fix_scale))
    assert int(t["n_inliers"]) == int(j["n_inliers"])
    assert np.array_equal(t["inliers"], j["inliers"])
    _same_pose(t, j, keys=("r", "t", "s"))


def test_sim3_lie_helpers_match_jax():
    rng = np.random.default_rng(0)
    xi = rng.uniform(-0.8, 0.8, (32, 7)).astype(np.float32)
    a = [np.asarray(x) for x in jse3.sim3_exp7(jnp.asarray(xi))]
    b = [x.numpy() for x in tse3.sim3_exp7(T(xi))]
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tse3.sim3_log7(*(T(x) for x in a)).numpy(),
                               np.asarray(jse3.sim3_log7(*(jnp.asarray(x) for x in a))),
                               atol=2e-4, rtol=0)
    c = [np.asarray(x) for x in jse3.sim3_compose([jnp.asarray(x[:16]) for x in a],
                                                  jse3.sim3_inv([jnp.asarray(x[16:])
                                                                 for x in a]))]
    d = [x.numpy() for x in tse3.sim3_compose([T(x[:16]) for x in a],
                                              tse3.sim3_inv([T(x[16:]) for x in a]))]
    for x, y in zip(c, d):
        np.testing.assert_allclose(y, x, atol=1e-5, rtol=0)
    tm = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 1, (16, 6)).astype(np.float32))))
    np.testing.assert_allclose(tse3.se3_log(T(tm)).numpy(), np.asarray(jse3.se3_log(
        jnp.asarray(tm))), atol=1e-5, rtol=0)
    q = rng.normal(0, 1, (16, 4)).astype(np.float32)
    np.testing.assert_allclose(tse3.quat_to_rot(T(q)).numpy(),
                               np.asarray(jse3.quat_to_rot(jnp.asarray(q))), atol=1e-6, rtol=0)


def test_pose_graph_matches_jax():
    n_kf = 12
    gt, est, edges, meas = make_loop_problem(n_kf)
    args = [np.stack([e[0] for e in est]), np.stack([e[1] for e in est]),
            np.stack([e[2] for e in est]).astype(np.float32), np.ones(n_kf, bool),
            np.eye(n_kf, dtype=bool)[0], np.array([e[0] for e in edges], np.int32),
            np.array([e[1] for e in edges], np.int32), np.stack([m[0] for m in meas]),
            np.stack([m[1] for m in meas]), np.stack([m[2] for m in meas]).astype(np.float32),
            np.ones(len(edges), np.float32), np.ones(len(edges), bool)]
    j = [np.asarray(x) for x in jpg.optimize_pose_graph(*(jnp.asarray(a) for a in args))]
    t = [x.numpy() for x in tpg.optimize_pose_graph(*(T(a) for a in args))]
    for x, y in zip(j, t):
        np.testing.assert_allclose(y, x, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t[0][0], est[0][0])  # the fixed vertex
