"""Motion-only pose optimisation: Levenberg-Marquardt on SE3 (port of
anyfeature_vslam_tpu/ops/pose_opt.py).

Reference Optimizer::PoseOptimization (src/Optimizer.cc:245-448): Huber
delta sqrt(5.991) on the whitened reprojection error, 4 rounds of up to
10 LM iterations, inliers re-classified at chi2 5.991 after each round,
Huber off in the last round. The JAX package leaves a round's
``while_loop`` once a step is below ``DX_TOL``; here each round is a fixed
10-step loop whose state freezes (``torch.where``) once done, which gives
the same result without a host sync per iteration. The 6x6 solve is
``torch.linalg.solve_ex`` (no error check, so no sync either; a singular
system yields a non-finite step that is rejected, as in JAX).
"""

from __future__ import annotations

import math

import torch

from . import se3

CHI2_MONO = 5.991  # 2-dof 95% (reference src/Optimizer.cc:39-51)
HUBER_DELTA = math.sqrt(CHI2_MONO)
N_ROUNDS = 4
N_ITERS = 10
DX_TOL = 1e-5


def _residuals_jac(t_cw, pts_w, uv, fx, fy, cx, cy):
    """Residuals e = proj(T X) - uv (N, 2), Jacobians de/dxi (N, 2, 6) for
    xi = (rho, phi) with a left update, and depths z (N,)."""
    p = pts_w @ t_cw[:3, :3].T + t_cw[:3, 3]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    e = torch.stack([fx * x * inv_z + cx - uv[:, 0], fy * y * inv_z + cy - uv[:, 1]], -1)
    zero = torch.zeros_like(x)
    j_p = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * x * inv_z2], -1),
        torch.stack([zero, fy * inv_z, -fy * y * inv_z2], -1),
    ], -2)  # (N, 2, 3)
    # dP/dxi for the left update: [I | -hat(P)]
    j = torch.cat([j_p, j_p @ -se3.hat(p)], -1)
    return e, j, z


def _chi2(e, inv_sigma2):
    return torch.sum(e * e, dim=-1) * inv_sigma2


def _huber_weight(chi2, use_huber: bool):
    if not use_huber:
        return torch.ones_like(chi2)
    n = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(n <= HUBER_DELTA, torch.ones_like(n), HUBER_DELTA / n)


def _robust_cost(chi2, use_huber: bool):
    if not use_huber:
        return chi2
    lin = 2.0 * HUBER_DELTA * torch.sqrt(torch.clamp(chi2, min=1e-12)) - HUBER_DELTA ** 2
    return torch.where(chi2 <= CHI2_MONO, chi2, lin)


def pose_optimize(t_cw0, pts_w, uv, inv_sigma2, valid, fx, fy, cx, cy):
    """Optimise one frame's (4, 4) world->camera pose against matched map
    points pts_w (N, 3) observed at undistorted uv (N, 2) with information
    inv_sigma2 (N,) where valid (N,). Returns (t_cw, inlier (N,) bool,
    n_inliers 0-d int32)."""
    dev = t_cw0.device
    eye6 = torch.eye(6, device=dev)
    t_cw, inlier = t_cw0, valid

    def cost_at(t_mat, use_huber):
        e, _, _ = _residuals_jac(t_mat, pts_w, uv, fx, fy, cx, cy)
        c = _robust_cost(_chi2(e, inv_sigma2), use_huber)
        return torch.sum(torch.where(inlier, c, torch.zeros_like(c)))

    for rnd in range(N_ROUNDS):
        use_huber = rnd < N_ROUNDS - 1
        lam = torch.full((), 1e-3, device=dev)  # a fill: no host copy
        cost = cost_at(t_cw, use_huber)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(N_ITERS):
            e, j, _ = _residuals_jac(t_cw, pts_w, uv, fx, fy, cx, cy)
            w = _huber_weight(_chi2(e, inv_sigma2), use_huber) * inv_sigma2
            w = torch.where(inlier, w, torch.zeros_like(w))
            jw = j * w[:, None, None]
            h = torch.einsum("nij,nik->jk", jw, j)
            g = torch.einsum("nij,ni->j", jw, e)
            h_lm = h + lam * torch.diag(torch.diagonal(h)) + 1e-8 * eye6
            dx = -torch.linalg.solve_ex(h_lm, g[:, None])[0][:, 0]
            t_new = se3.se3_exp(dx) @ t_cw
            new_cost = cost_at(t_new, use_huber)
            accept = (new_cost < cost) & torch.all(torch.isfinite(dx)) & ~done
            t_cw = torch.where(accept, t_new, t_cw)
            cost = torch.where(accept, new_cost, cost)
            lam_next = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
            lam = torch.where(done, lam, lam_next)
            done = done | (torch.max(torch.abs(dx)) < DX_TOL)
        # re-classify all observations (outliers can come back)
        e, _, z = _residuals_jac(t_cw, pts_w, uv, fx, fy, cx, cy)
        inlier = valid & (_chi2(e, inv_sigma2) <= CHI2_MONO) & (z > 0)
    return t_cw, inlier, inlier.sum(dtype=torch.int32)
