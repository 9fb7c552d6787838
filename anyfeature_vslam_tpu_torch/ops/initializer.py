"""Monocular two-view initialization: batched H/F RANSAC + reconstruction
(port of anyfeature_vslam_tpu/ops/initializer.py).

Reference behavior (src/Initializer.cc:40-910): 200 RANSAC sets of 8
correspondences; homography (DLT, symmetric transfer chi2 score) and
fundamental (8-point, epipolar chi2 score) fitted and scored for all 200
hypotheses as one batched eigh; RH = SH/(SH+SF) > 0.40 picks H; an
all-inlier refit of the best hypotheses; reconstruction tries 4 motions
from E or 8 planar-homography motions (SVD decomposition of Ma, Soatto,
Kosecka & Sastry, "An Invitation to 3-D Vision", Alg. 5.2) and CheckRT
gates: cheirality, reprojection < 4 sigma^2, parallax.

The RANSAC draws are an argument: by default ``rng.uniform(seed, (200,
N))``, the JAX package's ``jax.random.uniform`` draws bit for bit, so the
same seed samples the same hypotheses. Eigenvector and SVD signs may differ
from JAX's, but the candidate motion set {R1, R2} x {+t, -t} (and its
homography counterpart) does not, so the chosen motion is the same.
"""

from __future__ import annotations

import torch

from . import rng, triangulation

N_HYP = 200  # reference Tracking.cc:459 (Initializer(..., 200))
SET_SIZE = 8
CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991
REPROJ_TH2 = 4.0  # * sigma^2 (sigma = 1 at init)
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50
COS_PARALLAX_TH = 0.99998


def _normalize(uv, valid):
    """Mean / mean-abs-dev normalization (reference Initializer::Normalize)."""
    n = torch.clamp(valid.sum(), min=1)
    v = valid[:, None]
    mean = torch.where(v, uv, torch.zeros_like(uv)).sum(0) / n
    dev = torch.where(v, torch.abs(uv - mean), torch.zeros_like(uv)).sum(0) / n
    s = 1.0 / torch.clamp(dev, min=1e-6)
    uvn = (uv - mean) * s
    z = torch.zeros_like(s[0])
    o = torch.ones_like(s[0])
    t = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, o]),
    ])
    return uvn, t


def sample_sets(draws, valid):
    """(N_HYP, SET_SIZE) indices of valid matches: the SET_SIZE largest
    draws per hypothesis, lower index first among ties (``lax.top_k``)."""
    u = torch.where(valid[None, :], draws, torch.full_like(draws, -1.0))
    return torch.sort(u, dim=-1, descending=True, stable=True).indices[:, :SET_SIZE]


def _smallest_eigvec(a):
    _, vecs = torch.linalg.eigh(a)
    return vecs[..., :, 0]


def _f_rows(x1, y1, x2, y2):
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _h_rows(x1, y1, x2, y2):
    one, zero = torch.ones_like(x1), torch.zeros_like(x1)
    r1 = torch.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], dim=-1)
    return r1, r2


def _rank2(f):
    u, s, vt = torch.linalg.svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ (s[..., None] * vt)


def _fit_fundamental(x1, y1, x2, y2):
    a = _f_rows(x1, y1, x2, y2)  # (H, 8, 9)
    ata = torch.einsum("hni,hnj->hij", a, a)
    return _rank2(_smallest_eigvec(ata).reshape(-1, 3, 3))


def _fit_homography(x1, y1, x2, y2):
    r1, r2 = _h_rows(x1, y1, x2, y2)
    a = torch.cat([r1, r2], dim=1)  # (H, 16, 9)
    ata = torch.einsum("hni,hnj->hij", a, a)
    return _smallest_eigvec(ata).reshape(-1, 3, 3)


def _homog(uv):
    return torch.cat([uv, torch.ones_like(uv[:, :1])], dim=-1)


def _score_homography(h, h_inv, uv1, uv2, valid):
    """Symmetric transfer chi2 score (reference CheckHomography)."""
    p1, p2 = _homog(uv1), _homog(uv2)

    def transfer(mat, src, dst):
        q = src @ mat.transpose(-1, -2)  # (H, N, 3)
        w = q[..., 2]
        w = torch.where(torch.abs(w) < 1e-9, torch.full_like(w, 1e-9), w)
        d = q[..., :2] / w[..., None] - dst[None, :, :2]
        return torch.sum(d * d, -1)

    chi2_21 = transfer(h, p1, p2)
    chi2_12 = transfer(h_inv, p2, p1)
    in1 = chi2_21 < CHI2_H
    in2 = chi2_12 < CHI2_H
    zero = torch.zeros_like(chi2_21)
    score = torch.where(in1, CHI2_H - chi2_21, zero) + torch.where(in2, CHI2_H - chi2_12, zero)
    score = torch.where(valid[None, :], score, zero)
    return score.sum(-1), in1 & in2 & valid[None, :]


def _score_fundamental(f, uv1, uv2, valid):
    """Epipolar-distance chi2 score (reference CheckFundamental)."""
    p1, p2 = _homog(uv1), _homog(uv2)
    l2 = p1 @ f.transpose(-1, -2)
    num2 = torch.sum(l2 * p2[None], -1)
    chi2_2 = num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    l1 = p2 @ f
    num1 = torch.sum(l1 * p1[None], -1)
    chi2_1 = num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    in2 = chi2_2 < CHI2_F
    in1 = chi2_1 < CHI2_F
    zero = torch.zeros_like(chi2_2)
    score = torch.where(in2, SCORE_TH - chi2_2, zero) + torch.where(in1, SCORE_TH - chi2_1, zero)
    score = torch.where(valid[None, :], score, zero)
    return score.sum(-1), in1 & in2 & valid[None, :]


def _w_matrix(like):
    return torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                        dtype=like.dtype, device=like.device)


def _motions_from_e(e):
    """4 candidate (R, t) from an essential matrix (reference DecomposeE)."""
    u, _, vt = torch.linalg.svd(e)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    w = _w_matrix(e)
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([r1, r1, r2, r2]), torch.stack([t, -t, t, -t])


def _motions_from_h(h_pix, k, k_inv):
    """8 candidate (R, t) from a homography: Ma-Soatto-Kosecka-Sastry Alg
    5.2 on H' = K^-1 H K, for both signs of H'."""
    hn = k_inv @ h_pix @ k
    sv = torch.linalg.svdvals(hn)
    hn = hn / torch.clamp(sv[1], min=1e-12)

    def decompose(hmat):
        evals, v = torch.linalg.eigh(hmat.T @ hmat)  # ascending
        s3sq, s1sq = evals[0], evals[2]
        v1, v2, v3 = v[:, 2], v[:, 1], v[:, 0]
        denom = torch.clamp(s1sq - s3sq, min=1e-12)
        a = torch.sqrt(torch.clamp(1.0 - s3sq, min=0.0) / denom)
        b = torch.sqrt(torch.clamp(s1sq - 1.0, min=0.0) / denom)

        def solution(u):
            big_u = torch.stack([v2, u, torch.linalg.cross(v2, u)], dim=1)
            hv2, hu = hmat @ v2, hmat @ u
            big_w = torch.stack([hv2, hu, torch.linalg.cross(hv2, hu)], dim=1)
            r = big_w @ big_u.T
            return r, (hmat - r) @ torch.linalg.cross(v2, u)

        r1, t1 = solution(a * v1 + b * v3)
        r2, t2 = solution(a * v1 - b * v3)
        return torch.stack([r1, r2, r1, r2]), torch.stack([t1, t2, -t1, -t2])

    ra, ta = decompose(hn)
    rb, tb = decompose(-hn)
    rs = torch.cat([ra, rb])
    ts = torch.cat([ta, tb])
    return rs, ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)


def _check_rt(rs, ts, uv1, uv2, inlier, k):
    """CheckRT for M motion hypotheses at once: cheirality in both views,
    reprojection < 4 sigma^2, parallax-gated depth test. Returns (n_good
    (M,), parallax_deg (M,), pts3d (M, N, 3), good (M, N))."""
    m, n = rs.shape[0], uv1.shape[0]
    eye4 = torch.eye(4, dtype=k.dtype, device=k.device)
    p1 = k @ eye4[:3]
    rt = torch.cat([rs, ts[:, :, None]], dim=2)  # (M, 3, 4)
    p2 = (k @ rt)[:, None]
    pts = triangulation.triangulate_dlt(p1, p2, uv1.expand(m, n, 2), uv2.expand(m, n, 2))
    finite = torch.isfinite(pts).all(-1)
    pts = torch.where(finite[..., None], pts, torch.zeros_like(pts))
    o2 = -torch.einsum("mji,mj->mi", rs, ts)  # -R^T t
    cosp = triangulation.parallax_cos(pts, torch.zeros_like(o2[:, None]), o2[:, None])
    pc2 = torch.einsum("mij,mnj->mni", rs, pts) + ts[:, None, :]
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]

    def err2(pc, uv):
        z = pc[..., 2]
        inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        du = fx * pc[..., 0] * inv_z + cx - uv[..., 0]
        dv = fy * pc[..., 1] * inv_z + cy - uv[..., 1]
        return du * du + dv * dv

    good = (inlier[None] & finite & (pts[..., 2] > 0) & (pc2[..., 2] > 0)
            & ~(cosp > COS_PARALLAX_TH)
            & (err2(pts, uv1) < REPROJ_TH2) & (err2(pc2, uv2) < REPROJ_TH2))
    n_good = good.sum(-1, dtype=torch.int32)
    # robust parallax: the 50th largest angle among good points (reference
    # sorts cosines ascending and takes index min(50, n-1))
    cos_sorted = torch.sort(torch.where(good, cosp, torch.ones_like(cosp)), dim=-1).values
    idx = torch.clamp(n_good - 1, min=0).clamp(max=50).long()
    par_cos = torch.gather(cos_sorted, 1, idx[:, None])[:, 0]
    parallax = torch.rad2deg(torch.arccos(torch.clamp(par_cos, -1.0, 1.0)))
    return n_good, parallax, pts, good


def initialize_two_view(uv1, uv2, valid, k_mat, seed: int = 0, draws=None):
    """Full two-view bootstrap.

    uv1, uv2: (N, 2) undistorted pixel coords of matched keypoints
    (reference frame / current frame); valid: (N,) bool; k_mat: (3, 3);
    seed: RANSAC seed; draws: optional (N_HYP, N) uniform draws (default
    ``rng.uniform(seed, (N_HYP, N))``). Returns the JAX function's dict:
    success, t21 (4, 4), pts3d (N, 3), good (N,), used_homography, rh,
    n_good, n_inliers, second_good, parallax_deg.
    """
    dev = uv1.device
    n = uv1.shape[0]
    if draws is None:
        draws = torch.from_numpy(rng.uniform(seed, (N_HYP, n))).to(dev)
    uv1n, t1 = _normalize(uv1, valid)
    uv2n, t2 = _normalize(uv2, valid)
    t2_inv = torch.linalg.inv_ex(t2)[0]

    sets = sample_sets(draws, valid)
    s1, s2 = uv1n[sets], uv2n[sets]  # (H, 8, 2)
    args = (s1[..., 0], s1[..., 1], s2[..., 0], s2[..., 1])
    f_n = _fit_fundamental(*args)
    h_n = _fit_homography(*args)
    f_pix = t2.T[None] @ f_n @ t1[None]
    h_pix = t2_inv[None] @ h_n @ t1[None]
    h_pix_inv = torch.linalg.inv_ex(h_pix)[0]
    sh, h_inliers = _score_homography(h_pix, h_pix_inv, uv1, uv2, valid)
    sf, f_inliers = _score_fundamental(f_pix, uv1, uv2, valid)
    best_h = torch.argmax(sh)
    best_f = torch.argmax(sf)

    # all-inlier refit of the best hypotheses (guided final fit)
    x1, y1, x2, y2 = uv1n[:, 0], uv1n[:, 1], uv2n[:, 0], uv2n[:, 1]
    w = f_inliers[best_f].to(torch.float32)
    a = _f_rows(x1, y1, x2, y2)
    f_ref = _rank2(_smallest_eigvec(torch.einsum("ni,nj->ij", a * w[:, None], a)).reshape(3, 3))
    f_refit = (t2.T @ f_ref @ t1)[None]
    w = h_inliers[best_h].to(torch.float32)
    r1, r2 = _h_rows(x1, y1, x2, y2)
    a = torch.cat([r1 * w[:, None], r2 * w[:, None]], dim=0)
    h_ref = _smallest_eigvec(torch.einsum("ni,nj->ij", a, a)).reshape(3, 3)
    h_refit = (t2_inv @ h_ref @ t1)[None]
    sf_r, f_inl_r = _score_fundamental(f_refit, uv1, uv2, valid)
    sh_r, h_inl_r = _score_homography(h_refit, torch.linalg.inv_ex(h_refit)[0], uv1, uv2, valid)
    f_better = sf_r[0] > sf[best_f]
    h_better = sh_r[0] > sh[best_h]
    f_best_mat = torch.where(f_better, f_refit[0], f_pix[best_f])
    h_best_mat = torch.where(h_better, h_refit[0], h_pix[best_h])
    f_best_inl = torch.where(f_better, f_inl_r[0], f_inliers[best_f])
    h_best_inl = torch.where(h_better, h_inl_r[0], h_inliers[best_h])
    sh_best = torch.maximum(sh[best_h], sh_r[0])
    sf_best = torch.maximum(sf[best_f], sf_r[0])
    rh = sh_best / torch.clamp(sh_best + sf_best, min=1e-9)
    use_h = rh > 0.40

    rs_f, ts_f = _motions_from_e(k_mat.T @ f_best_mat @ k_mat)
    rs_h, ts_h = _motions_from_h(h_best_mat, k_mat, torch.linalg.inv_ex(k_mat)[0])
    rs = torch.cat([rs_f, rs_h])  # (12, 3, 3)
    ts = torch.cat([ts_f, ts_h])
    is_f = torch.arange(12, device=dev) < 4
    inlier_sel = torch.where(use_h, h_best_inl, f_best_inl)
    cand_active = torch.where(use_h, ~is_f, is_f)
    n_good, par, pts, good = _check_rt(rs, ts, uv1, uv2, inlier_sel, k_mat)
    n_good = torch.where(cand_active, n_good, torch.full_like(n_good, -1))
    best = torch.argmax(n_good)
    best_good = n_good[best]
    second = torch.where(torch.arange(12, device=dev) == best, torch.full_like(n_good, -1),
                         n_good).max()
    n_inliers = inlier_sel.sum(dtype=torch.int32)
    min_good = torch.clamp((0.9 * n_inliers).to(torch.int32), min=MIN_TRIANGULATED)
    success = (best_good >= min_good) & (second < 0.75 * best_good) & (par[best] > MIN_PARALLAX_DEG)
    t21 = torch.eye(4, dtype=rs.dtype, device=dev)
    t21 = torch.cat([torch.cat([rs[best], ts[best][:, None]], 1), t21[3:]], 0)
    return dict(
        success=success, t21=t21, pts3d=pts[best], good=good[best] & success,
        used_homography=use_h, rh=rh, n_good=best_good, n_inliers=n_inliers,
        second_good=second, parallax_deg=par[best],
    )
