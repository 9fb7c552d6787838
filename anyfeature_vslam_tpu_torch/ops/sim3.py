"""Sim3 between two keyframes for loop closing: Horn's closed form, RANSAC
and LM refinement (port of anyfeature_vslam_tpu/ops/sim3.py).

The counterpart of the reference Sim3Solver (reference
src/Sim3Solver.cc:38-325: 3-point RANSAC over matched map-point pairs,
absolute orientation in closed form from the largest eigenvector of Horn's
4x4 N matrix, free scale for monocular, inliers by mutual reprojection
error < 9.21 sigma^2) and of Optimizer::OptimizeSim3
(src/Optimizer.cc:1033-1226). All RANSAC hypotheses are one batched
``eigh``; the draws are the JAX package's ``uniform(seed, (200, N))``
(ops/rng.py), so both packages try the same subsets. The LM's ``lax.scan``s
are fixed loops whose state is selected with ``torch.where`` (no host sync
per step); the Jacobians are forward-mode (``se3.jacfwd``), as the JAX
package's ``jax.jacfwd``.
"""

from __future__ import annotations

import torch

from . import se3
from .pnp import first_argmax, subsets

CHI2_INLIER = 9.21
MIN_SET = 3


def horn_sim3(a, b, w, fix_scale: bool = False):
    """Closed-form similarity b ~= s R a + t. a, b (..., N, 3); w (..., N).
    Returns (r (..., 3, 3), t (..., 3), s (...,)). The quaternion's sign
    (an eigenvector's) does not change R."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    ca = torch.sum(a * w[..., None], dim=-2) / wsum
    cb = torch.sum(b * w[..., None], dim=-2) / wsum
    a0 = a - ca[..., None, :]
    b0 = b - cb[..., None, :]
    m = torch.einsum("...ni,...nj->...ij", a0 * w[..., None], b0)
    sxx, sxy, sxz = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    syx, syy, syz = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    szx, szy, szz = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    n_mat = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], dim=-1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], dim=-1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], dim=-1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], dim=-1),
    ], dim=-2)
    q = torch.linalg.eigh(n_mat)[1][..., :, -1]  # largest eigenvalue: (w, x, y, z)
    r = se3.quat_to_rot(torch.stack([q[..., 1], q[..., 2], q[..., 3], q[..., 0]], dim=-1))
    # scale (reference Sim3Solver.cc:284-303): sum(b0 . R a0) / sum(|a0|^2)
    ra = torch.einsum("...ij,...nj->...ni", r, a0)
    num = torch.sum(torch.sum(b0 * ra, dim=-1) * w, dim=-1)
    den = torch.clamp(torch.sum(torch.sum(a0 * a0, dim=-1) * w, dim=-1), min=1e-12)
    s = torch.ones_like(num) if fix_scale else num / den
    t = cb - s[..., None] * torch.einsum("...ij,...j->...i", r, ca)
    return r, t, s


def _project(pc, fx, fy, cx, cy):
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([fx * pc[..., 0] / zs + cx, fy * pc[..., 1] / zs + cy], dim=-1), z


def sim3_ransac(pc1, pc2, uv1, uv2, sigma2_1, sigma2_2, valid, fx, fy, cx, cy, seed,
                n_hyp: int = 200, fix_scale: bool = False):
    """Sim3 S12 (pc1 ~= s R pc2 + t) from matched points in the two
    keyframes' camera frames: pc1, pc2 (N, 3); their keypoints uv1, uv2
    (N, 2); sigma^2 per keypoint (N,); valid (N,). Returns dict(r, t, s,
    inliers, n_inliers)."""
    sets = subsets(seed, valid, n_hyp, MIN_SET)  # (H, 3)
    r_h, t_h, s_h = horn_sim3(pc2[sets], pc1[sets], torch.ones(sets.shape, device=pc1.device),
                              fix_scale=fix_scale)
    # mutual reprojection: transformed pc2 into image 1, pc1 into image 2
    p2in1 = s_h[:, None, None] * torch.einsum("hij,nj->hni", r_h, pc2) + t_h[:, None, :]
    uv_2in1, z1 = _project(p2in1, fx, fy, cx, cy)
    r_inv = r_h.transpose(-1, -2)
    s_inv = 1.0 / torch.clamp(s_h, min=1e-12)
    t_inv = -s_inv[:, None] * torch.einsum("hij,hj->hi", r_inv, t_h)
    p1in2 = s_inv[:, None, None] * torch.einsum("hij,nj->hni", r_inv, pc1) + t_inv[:, None, :]
    uv_1in2, z2 = _project(p1in2, fx, fy, cx, cy)
    e1 = torch.sum((uv_2in1 - uv1[None]) ** 2, dim=-1)
    e2 = torch.sum((uv_1in2 - uv2[None]) ** 2, dim=-1)
    inl = ((e1 < CHI2_INLIER * sigma2_1[None]) & (e2 < CHI2_INLIER * sigma2_2[None])
           & (z1 > 0) & (z2 > 0) & valid[None])
    counts = inl.sum(-1)
    best = first_argmax(counts)
    # refit on all inliers of the winner
    r_f, t_f, s_f = horn_sim3(pc2, pc1, inl[best].to(pc1.dtype), fix_scale=fix_scale)
    uv_a, z1f = _project(s_f * (pc2 @ r_f.T) + t_f, fx, fy, cx, cy)
    uv_b, z2f = _project((1.0 / torch.clamp(s_f, min=1e-12)) * ((pc1 - t_f) @ r_f), fx, fy, cx, cy)
    e1f = torch.sum((uv_a - uv1) ** 2, dim=-1)
    e2f = torch.sum((uv_b - uv2) ** 2, dim=-1)
    inl_f = ((e1f < CHI2_INLIER * sigma2_1) & (e2f < CHI2_INLIER * sigma2_2)
             & (z1f > 0) & (z2f > 0) & valid)
    n_f = inl_f.sum()
    better = n_f >= counts[best]
    return dict(r=torch.where(better, r_f, r_h[best]), t=torch.where(better, t_f, t_h[best]),
                s=torch.where(better, s_f, s_h[best]),
                inliers=torch.where(better, inl_f, inl[best]),
                n_inliers=torch.maximum(counts[best], n_f).to(torch.int32))


def sim3_optimize(r, t, s, pc1, pc2, uv1, uv2, inv_s2_1, inv_s2_2, valid, fx, fy, cx, cy,
                  th2: float = 10.0, n_iters: int = 10, fix_scale: bool = False):
    """LM refinement of a Sim3 over matched pairs (reference OptimizeSim3):
    one Sim3 vertex, forward edges project(S12 pc2) - uv1 and inverse edges
    project(S12^-1 pc1) - uv2, Huber delta sqrt(th2), n_iters steps, an
    outlier pass, n_iters more steps, and both-direction chi2
    classification. r, t, s: the start (tensors or arrays). Returns
    dict(r, t, s, inliers, n_inliers). The second stage is the JAX
    package's as it runs under JAX 0.9: its second ``lax.scan`` reuses the
    first stage's trace, so its steps are scored with the weights from
    before the outlier pass against a start cost taken with the survivors'
    weights. Where the pass drops a pair, nearly every step is rejected;
    where it drops none, it is n_iters more plain steps (ROADMAP.md,
    faults)."""
    dev = pc1.device
    f32 = torch.float32
    r = torch.as_tensor(r, dtype=f32, device=dev)
    t = torch.as_tensor(t, dtype=f32, device=dev)
    log_s0 = torch.log(torch.clamp(torch.as_tensor(s, dtype=f32, device=dev), min=1e-12))
    zero_w = torch.zeros_like(inv_s2_1)
    w1_full = torch.where(valid, inv_s2_1, zero_w)
    w2_full = torch.where(valid, inv_s2_2, zero_w)
    delta_h = th2 ** 0.5
    zero7 = torch.zeros(7, dtype=f32, device=dev)
    eye7 = torch.eye(7, dtype=f32, device=dev)

    def residuals(xi, r0, t0, ls0):
        """Forward and inverse reprojection errors, (..., N, 2) each, for
        perturbations xi (..., 7) of the Sim3 (r0, t0, exp(ls0))."""
        dr, dt, ds = se3.sim3_exp7(xi)
        rr = dr @ r0
        tt = ds[..., None] * (dr @ t0[:, None])[..., 0] + dt
        ss = torch.exp(ls0) * (torch.ones_like(ds) if fix_scale else ds)
        p1h, _ = _project(ss[..., None, None] * (pc2 @ rr.transpose(-1, -2)) + tt[..., None, :],
                          fx, fy, cx, cy)
        p2h, _ = _project((pc1 - tt[..., None, :]) @ rr / ss[..., None, None], fx, fy, cx, cy)
        return p1h - uv1, p2h - uv2

    def chi2_of(e1, e2, w1=w1_full, w2=w2_full):
        return torch.sum(e1 * e1, -1) * w1, torch.sum(e2 * e2, -1) * w2

    def huber_w(chi2):
        nrm = torch.sqrt(torch.clamp(chi2, min=1e-12))
        return torch.where(nrm <= delta_h, torch.ones_like(nrm), delta_h / nrm)

    def capped_cost(c1, c2):
        return torch.sum(torch.clamp(c1, max=th2 * 4) + torch.clamp(c2, max=th2 * 4))

    def lm(r0, t0, ls0, cost):
        lam = torch.tensor(1e-4, dtype=f32, device=dev)
        for _ in range(n_iters):
            e1, e2 = residuals(zero7, r0, t0, ls0)
            ((j1, j2),) = se3.jacfwd(lambda xi: residuals(xi, r0, t0, ls0), zero7)  # (N, 2, 7)
            c1, c2 = chi2_of(e1, e2)
            rw1 = w1_full * huber_w(c1)
            rw2 = w2_full * huber_w(c2)
            h = (torch.einsum("nij,n,nik->jk", j1, rw1, j1)
                 + torch.einsum("nij,n,nik->jk", j2, rw2, j2))
            g = -(torch.einsum("nij,n,ni->j", j1, rw1, e1)
                  + torch.einsum("nij,n,ni->j", j2, rw2, e2))
            h = h + (lam + 1e-8) * eye7 * (1.0 + torch.diagonal(h).mean())
            dx = torch.linalg.solve_ex(h, g[:, None])[0][:, 0]
            dr, dt, ds = se3.sim3_exp7(dx)
            r1 = dr @ r0
            if fix_scale:
                t1, ls1 = dr @ t0 + dt, ls0
            else:
                t1, ls1 = ds * (dr @ t0) + dt, ls0 + torch.log(ds)
            new_cost = capped_cost(*chi2_of(*residuals(zero7, r1, t1, ls1)))
            ok = torch.isfinite(new_cost) & (new_cost < cost) & torch.all(torch.isfinite(dx))
            r0 = torch.where(ok, r1, r0)
            t0 = torch.where(ok, t1, t0)
            ls0 = torch.where(ok, ls1, ls0)
            cost = torch.where(ok, new_cost, cost)
            lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 5.0), 1e-10, 1e6)
        return r0, t0, ls0

    r, t, log_s = lm(r, t, log_s0, capped_cost(*chi2_of(*residuals(zero7, r, t, log_s0))))
    # outlier pass, then the second stage (reference src/Optimizer.cc:
    # 1170-1202 re-optimizes on the survivors; the JAX package's stage
    # starts from the survivors' cost and steps with the old weights)
    e1, e2 = residuals(zero7, r, t, log_s)
    c1, c2 = chi2_of(e1, e2)
    keep = valid & (c1 <= th2) & (c2 <= th2)
    cost1 = capped_cost(*chi2_of(e1, e2, torch.where(keep, w1_full, zero_w),
                                 torch.where(keep, w2_full, zero_w)))
    r, t, log_s = lm(r, t, log_s, cost1)
    c1, c2 = chi2_of(*residuals(zero7, r, t, log_s))
    inl = valid & (c1 <= th2) & (c2 <= th2)
    return dict(r=r, t=t, s=torch.exp(log_s), inliers=inl, n_inliers=inl.sum().to(torch.int32))
