"""Ground-truth geometry: camera centres, the similarity alignment,
back-projection and projection (numpy, float64)."""

from __future__ import annotations

import numpy as np


def centres(t_cw: np.ndarray) -> np.ndarray:
    """(N, 3) camera centres of world-to-camera poses (N, 4, 4)."""
    t = np.asarray(t_cw, np.float64)
    return -np.einsum("nji,nj->ni", t[:, :3, :3], t[:, :3, 3])


def align(est_t_cw: np.ndarray, true_t_cw: np.ndarray):
    """(s, R, t) taking the estimated world onto the true one: R the
    chordal mean of the frames' R_true_wc R_est_wc^T (a camera path on a
    straight line leaves the rotation about the line free in an alignment
    of centres alone), then s and t by least squares on the camera
    centres, |c_true - (s R c_est + t)|^2."""
    est = np.asarray(est_t_cw, np.float64)
    true = np.asarray(true_t_cw, np.float64)
    # R_wc = R_cw^T
    m = np.einsum("nji,njk->ik", true[:, :3, :3], est[:, :3, :3])
    u, _, vt = np.linalg.svd(m)
    e = np.eye(3)
    e[2, 2] = np.sign(np.linalg.det(u @ vt))
    r = u @ e @ vt
    c_est, c_true = centres(est), centres(true)
    xe = (c_est - c_est.mean(0)) @ r.T
    xt = c_true - c_true.mean(0)
    s = float((xe * xt).sum() / max((xe * xe).sum(), 1e-300))
    return s, r, c_true.mean(0) - s * r @ c_est.mean(0)


def apply(sim, pts: np.ndarray) -> np.ndarray:
    s, r, t = sim
    return s * np.asarray(pts, np.float64) @ r.T + t


def backproject(uv: np.ndarray, depth: np.ndarray, cam: dict, t_cw: np.ndarray):
    """(world points (N, 3), usable (N,)) of pixels uv through the rendered
    depth map of view t_cw: usable where the 3x3 depth around the pixel is
    on one surface (no rim between two depths)."""
    h, w = depth.shape
    xi = np.clip(np.round(uv[:, 0]).astype(np.int64), 1, w - 2)
    yi = np.clip(np.round(uv[:, 1]).astype(np.int64), 1, h - 2)
    win = np.stack([depth[yi + dy, xi + dx] for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    z = depth[yi, xi].astype(np.float64)
    ok = (win.min(0) > 0) & (win.max(0) - win.min(0) < 0.01 * z)
    p_c = np.stack([(uv[:, 0] - cam["cx"]) / cam["fx"] * z, (uv[:, 1] - cam["cy"]) / cam["fy"] * z,
                    z], 1)
    t = np.asarray(t_cw, np.float64)
    return (p_c - t[:3, 3]) @ t[:3, :3], ok


def project(pts: np.ndarray, cam: dict, t_cw: np.ndarray) -> np.ndarray:
    """(N, 2) pixels of world points (N, 3) in view t_cw."""
    t = np.asarray(t_cw, np.float64)
    p = pts @ t[:3, :3].T + t[:3, 3]
    return np.stack([cam["fx"] * p[:, 0] / p[:, 2] + cam["cx"],
                     cam["fy"] * p[:, 1] / p[:, 2] + cam["cy"]], 1)
