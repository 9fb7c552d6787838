"""Trajectory evaluation: Sim3 alignment + ATE RMSE (VSLAM-LAB-style).

The reference delegates scoring to VSLAM-LAB (reference README.md:19): the
saved keyframe trajectory is Sim3-aligned to ground truth (monocular scale
is free) and the absolute trajectory error RMSE is reported. This module is
that scorer, framework-native: Umeyama closed-form alignment + RMSE, plus
timestamp association for trajectories sampled at different rates.

A copy of anyfeature_vslam_tpu/io/evaluation.py (numpy only), held equal
to it by tests/test_torch_constants.py.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x, y, with_scale: bool = True):
    """Least-squares Sim3 s, R, t with y ~ s R x + t (Umeyama 1991).

    x, y: (N, 3). Returns (s, R (3,3), t (3,))."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    mx = x.mean(0)
    my = y.mean(0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / len(x)
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1.0
    r = u @ s_fix @ vt
    if with_scale:
        var_x = (xc * xc).sum() / len(x)
        s = float(np.trace(np.diag(d) @ s_fix) / max(var_x, 1e-12))
    else:
        s = 1.0
    t = my - s * r @ mx
    return s, r, t


def associate(ts_a, ts_b, max_diff: float = 0.02):
    """Nearest-timestamp association. Returns index pairs (ia, ib)."""
    ts_a = np.asarray(ts_a, np.float64)
    ts_b = np.asarray(ts_b, np.float64)
    ia, ib = [], []
    j = 0
    order = np.argsort(ts_b)
    ts_bs = ts_b[order]
    for i, t in enumerate(ts_a):
        j = np.searchsorted(ts_bs, t)
        best, bd = -1, max_diff
        for k in (j - 1, j):
            if 0 <= k < len(ts_bs) and abs(ts_bs[k] - t) <= bd:
                best, bd = k, abs(ts_bs[k] - t)
        if best >= 0:
            ia.append(i)
            ib.append(int(order[best]))
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def ate_rmse(est_xyz, gt_xyz, with_scale: bool = True):
    """Sim3-aligned absolute trajectory error RMSE. Inputs (N, 3) paired."""
    s, r, t = umeyama_alignment(est_xyz, gt_xyz, with_scale=with_scale)
    aligned = (s * (np.asarray(est_xyz, np.float64) @ r.T)) + t
    err = aligned - np.asarray(gt_xyz, np.float64)
    return float(np.sqrt((err * err).sum(-1).mean())), (s, r, t)


def load_tum(path: str):
    """TUM trajectory: `ts tx ty tz qx qy qz qw` lines -> (ts, xyz)."""
    ts, xyz = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.replace(",", " ").split()]
            ts.append(v[0])
            xyz.append(v[1:4])
    return np.asarray(ts), np.asarray(xyz)


def load_vslamlab_csv(path: str):
    """Keyframe trajectory CSV (`ts (ns),tx,...`) -> (ts seconds, xyz)."""
    ts, xyz = [], []
    with open(path) as f:
        next(f)  # header
        for line in f:
            v = [float(x) for x in line.strip().split(",")]
            ts.append(v[0] * 1e-9)
            xyz.append(v[1:4])
    return np.asarray(ts), np.asarray(xyz)


def evaluate(est_path: str, gt_path: str, max_diff: float = 0.02):
    """Load, associate, align, score. Returns dict with ate_rmse + counts."""
    loader = load_vslamlab_csv if est_path.endswith(".csv") else load_tum
    ts_e, xyz_e = loader(est_path)
    ts_g, xyz_g = load_tum(gt_path)
    ia, ib = associate(ts_e, ts_g, max_diff)
    if len(ia) < 3:
        return dict(ate_rmse=float("inf"), n_pairs=int(len(ia)), scale=0.0)
    rmse, (s, _, _) = ate_rmse(xyz_e[ia], xyz_g[ib])
    return dict(ate_rmse=rmse, n_pairs=int(len(ia)), scale=s)
