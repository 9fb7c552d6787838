"""Batched RANSAC-EPnP: camera pose from 3D-2D matches, for relocalization
(port of anyfeature_vslam_tpu/ops/pnp.py).

The counterpart of the reference PnPsolver (reference
src/PnPsolver.cc:165-290: EPnP after Lepetit et al. 2009 inside RANSAC,
minimal set 4, per-point gate th2 * sigma^2, at most 300 iterations). Every
hypothesis of every candidate keyframe is one batch: control points from
the subset's centroid and PCA axes, barycentric coordinates, the 12-dim
null space of M^T M (batched eigh), betas from the N=1 closed form refined
by 10 Gauss-Newton steps, R and t by Procrustes; the winner by inlier count
(the first among equals), then a re-solve on all its inliers.

The draws are the JAX package's: ``uniform(seed, (300, N))`` from
ops/rng.py, the same for every candidate (the JAX vmap broadcasts the
seed), so both packages try the same 300 subsets. ``lax.top_k`` is a
stable descending sort. Eigenvector and singular-vector signs may differ
between libraries; the pose they give does not.
"""

from __future__ import annotations

import torch

from . import rng

RANSAC_TH2 = 5.991  # reference Tracking.h:322-328 (th2), scaled by sigma^2
MIN_SET = 4
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _control_points(pts, w):
    """Weighted centroid + PCA control points. pts (..., N, 3), w (..., N)."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    c0 = torch.sum(pts * w[..., None], dim=-2) / wsum
    a = (pts - c0[..., None, :]) * torch.sqrt(w)[..., None]
    cov = torch.einsum("...ni,...nj->...ij", a, a) / wsum[..., None]
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    s = torch.sqrt(torch.clamp(evals, min=1e-12))
    cpts = c0[..., None, :] + s[..., :, None] * evecs.transpose(-1, -2)
    return torch.cat([c0[..., None, :], cpts], dim=-2)  # (..., 4, 3)


def _barycentric(pts, cw):
    """alphas (..., N, 4) with pts = alphas @ cw and sum(alphas) = 1."""
    ones_c = torch.ones(cw.shape[:-2] + (1, 4), dtype=cw.dtype, device=cw.device)
    m = torch.cat([cw.transpose(-1, -2), ones_c], dim=-2)  # (..., 4, 4)
    rhs = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)  # (..., N, 4)
    return torch.einsum("...ij,...nj->...ni", torch.linalg.inv_ex(m)[0], rhs)


def _build_mtm(alphas, uv, w, fx, fy, cx, cy):
    """M^T M (..., 12, 12) of the 2N x 12 EPnP system, weighted by w."""
    u, v = uv[..., 0], uv[..., 1]
    zeros = torch.zeros_like(alphas)
    ru = torch.stack([alphas * fx, zeros, alphas * (cx - u)[..., None]], dim=-1)
    rv = torch.stack([zeros, alphas * fy, alphas * (cy - v)[..., None]], dim=-1)
    ru = ru.reshape(ru.shape[:-2] + (12,))
    rv = rv.reshape(rv.shape[:-2] + (12,))
    wn = w[..., None]
    return (torch.einsum("...ni,...nj->...ij", ru * wn, ru)
            + torch.einsum("...ni,...nj->...ij", rv * wn, rv))


def _pair_dists(c):
    """(..., 4, 3) control points -> (..., 6, 3) pairwise differences."""
    return torch.stack([c[..., i, :] - c[..., j, :] for i, j in _PAIRS], dim=-2)


def _betas_gauss_newton(v_kernel, dw2, n_gn: int = 10):
    """Betas in R^4 so that sum_k beta_k v_k reproduces the world
    control-point distances: the N=1 closed form on the smallest-eigenvalue
    kernel vector, then n_gn Gauss-Newton steps (the JAX scan, unrolled).
    v_kernel (..., 4, 4, 3) [kernel vector, control point, xyz]; dw2 (..., 6)."""
    vdiff = torch.stack([v_kernel[..., :, i, :] - v_kernel[..., :, j, :] for i, j in _PAIRS],
                        dim=-3)  # (..., 6, 4, 3)
    v1 = vdiff[..., 0, :]
    dc2 = torch.sum(v1 * v1, dim=-1)
    num = torch.sum(torch.sqrt(torch.clamp(dc2, min=1e-12))
                    * torch.sqrt(torch.clamp(dw2, min=1e-12)), dim=-1)
    b0 = num / torch.clamp(torch.sum(dc2, dim=-1), min=1e-12)
    zero = torch.zeros_like(b0)
    betas = torch.stack([b0, zero, zero, zero], dim=-1)
    eye = 1e-8 * torch.eye(4, dtype=betas.dtype, device=betas.device)
    for _ in range(n_gn):
        cc_diff = torch.einsum("...k,...pkx->...px", betas, vdiff)
        f = torch.sum(cc_diff * cc_diff, dim=-1) - dw2
        jac = 2.0 * torch.einsum("...px,...pkx->...pk", cc_diff, vdiff)
        jtj = torch.einsum("...pk,...pl->...kl", jac, jac) + eye
        jtf = torch.einsum("...pk,...p->...k", jac, f)
        betas = betas - torch.linalg.solve_ex(jtj, jtf[..., None])[0][..., 0]
    return betas


def _procrustes(a, b, w):
    """Rigid transform b ~= R a + t. a, b (..., N, 3), w (..., N) weights."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    ca = torch.sum(a * w[..., None], dim=-2) / wsum
    cb = torch.sum(b * w[..., None], dim=-2) / wsum
    a0 = a - ca[..., None, :]
    b0 = b - cb[..., None, :]
    h = torch.einsum("...ni,...nj->...ij", a0 * w[..., None], b0)
    u, _, vt = torch.linalg.svd(h)
    d = torch.linalg.det(vt.transpose(-1, -2) @ u.transpose(-1, -2))
    s = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    r = torch.einsum("...ji,...j,...kj->...ik", vt, s, u)  # V diag(s) U^T
    return r, cb - torch.einsum("...ij,...j->...i", r, ca)


def _epnp_solve(pts, uv, w, fx, fy, cx, cy):
    """Weighted EPnP: (r, t) with the inputs' leading batch dims."""
    cw = _control_points(pts, w)
    alphas = _barycentric(pts, cw)
    _, evecs = torch.linalg.eigh(_build_mtm(alphas, uv, w, fx, fy, cx, cy))
    vk = evecs[..., :, :4].transpose(-1, -2)  # 4 smallest -> (..., 4, 12)
    v_ctrl = vk.reshape(vk.shape[:-1] + (4, 3))
    dw = _pair_dists(cw)
    betas = _betas_gauss_newton(v_ctrl, torch.sum(dw * dw, dim=-1))
    cc = torch.einsum("...k,...kcx->...cx", betas, v_ctrl)
    pc = torch.einsum("...nc,...cx->...nx", alphas, cc)
    # depth sign: the weighted majority of z must be positive
    zsign = torch.sign(torch.sum(pc[..., 2] * w, dim=-1, keepdim=True))
    zsign = torch.where(zsign == 0, torch.ones_like(zsign), zsign)
    return _procrustes(pts, pc * zsign[..., None], w)


def _reproj_err2(r, t, pts, uv, fx, fy, cx, cy):
    pc = torch.einsum("...ij,...nj->...ni", r, pts) + t[..., None, :]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    e2 = (fx * pc[..., 0] / zs + cx - uv[..., 0]) ** 2 + (fy * pc[..., 1] / zs + cy - uv[..., 1]) ** 2
    return torch.where(z > 0, e2, torch.full_like(e2, float("inf")))


def first_argmax(x):
    """Index of the first maximum along the last axis (jnp.argmax's rule,
    independent of the backend's reduction order)."""
    n = x.shape[-1]
    ar = torch.arange(n, device=x.device).expand(x.shape)
    at_max = x == x.amax(dim=-1, keepdim=True)
    return torch.where(at_max, ar, torch.full_like(ar, n)).amin(dim=-1)


def subsets(seed: int, valid, n_hyp: int, size: int):
    """The JAX package's RANSAC subsets: the `size` largest of
    uniform(seed, (n_hyp, N)) per hypothesis, invalid rows drawn as -1,
    lower index first among equal keys (``lax.top_k``). valid (..., N);
    returns (..., n_hyp, size) int64."""
    n = valid.shape[-1]
    u = torch.from_numpy(rng.uniform(seed, (n_hyp, n))).to(valid.device)
    u = torch.where(valid[..., None, :], u, torch.full_like(u, -1.0))
    return torch.sort(u, dim=-1, descending=True, stable=True).indices[..., :size]


def pnp_ransac_many(pts, uv, sigma2, valid, fx, fy, cx, cy, seed, n_hyp: int = 300):
    """RANSAC-EPnP for C candidates at once (the JAX ``vmap`` of
    ``pnp_ransac`` written as a leading axis).

    pts (C, N, 3) world positions of the candidate matches; uv (C, N, 2)
    undistorted observations; sigma2 (C, N) keypoint sigma^2 (the gate is
    RANSAC_TH2 * sigma2); valid (C, N) bool. Returns dict(r (C, 3, 3), t
    (C, 3), inliers (C, N), n_inliers (C,)). No host sync."""
    c = pts.shape[0]
    sets = subsets(seed, valid, n_hyp, MIN_SET)  # (C, H, 4)
    bi = torch.arange(c, device=pts.device)[:, None, None]
    spts, suv = pts[bi, sets], uv[bi, sets]
    r_h, t_h = _epnp_solve(spts, suv, torch.ones(sets.shape, dtype=pts.dtype, device=pts.device),
                           fx, fy, cx, cy)  # (C, H, 3, 3), (C, H, 3)
    e2 = _reproj_err2(r_h, t_h, pts[:, None], uv[:, None], fx, fy, cx, cy)  # (C, H, N)
    inl = (e2 < RANSAC_TH2 * sigma2[:, None, :]) & valid[:, None, :]
    counts = inl.sum(-1)
    best = first_argmax(counts)  # (C,)
    ci = torch.arange(c, device=pts.device)
    best_inl = inl[ci, best]
    # refine: EPnP on all inliers of the best hypothesis (reference Refine,
    # src/PnPsolver.cc:260-290), kept if it loses no inlier
    r_f, t_f = _epnp_solve(pts, uv, best_inl.to(pts.dtype), fx, fy, cx, cy)
    e2_f = _reproj_err2(r_f, t_f, pts, uv, fx, fy, cx, cy)
    inl_f = (e2_f < RANSAC_TH2 * sigma2) & valid
    better = inl_f.sum(-1) >= counts[ci, best]
    r_out = torch.where(better[:, None, None], r_f, r_h[ci, best])
    t_out = torch.where(better[:, None], t_f, t_h[ci, best])
    inl_out = torch.where(better[:, None], inl_f, best_inl)
    return dict(r=r_out, t=t_out, inliers=inl_out, n_inliers=inl_out.sum(-1).to(torch.int32))


def pnp_ransac(pts, uv, sigma2, valid, fx, fy, cx, cy, seed, n_hyp: int = 300):
    """One candidate: pts (N, 3), uv (N, 2), sigma2 (N,), valid (N,).
    Returns dict(r, t, inliers, n_inliers) without the candidate axis."""
    out = pnp_ransac_many(pts[None], uv[None], sigma2[None], valid[None], fx, fy, cx, cy,
                          seed, n_hyp)
    return {k: v[0] for k, v in out.items()}
