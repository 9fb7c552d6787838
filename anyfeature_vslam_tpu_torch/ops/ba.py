"""Bundle adjustment: Levenberg-Marquardt with Schur complement (port of
anyfeature_vslam_tpu/ops/ba.py, single-device part).

Replaces the reference's g2o Optimizer::BundleAdjustment /
LocalBundleAdjustment (reference src/Optimizer.cc:61-243, 450-768): SE3
keyframe blocks + marginalized XYZ point blocks, 2-dof reprojection edges
with information 1/sigma^2, Huber delta sqrt(5.991). Fixed-capacity COO
observation arrays (kf_idx, pt_idx, uv, w, valid); points marginalized with
closed-form 3x3 inverses; the reduced camera system solved densely for
small block grids and with block-Jacobi preconditioned CG otherwise, chosen
from the padded sizes exactly as the JAX package chooses.

The JAX package leaves its LM and CG ``while_loop``s early (a step below
``DX_TOL``, a CG residual below ``CG_RTOL2``). Here every loop has its
fixed length and the state freezes (``torch.where``) once its loop would
have ended, which gives the same result with no host sync per iteration.
The dense solve is ``torch.linalg.solve_ex`` (no error check, no sync).

``compensated=True`` accumulates the normal equations with a two-float
segment sum (``segment_sum_compensated``: partial sums over chunks of the
observations, combined by a TwoSum running-error scan) and takes the CG
path. ``_bundle_adjust_impl`` (the CG solve) also runs one shard of a
solve spread over the ranks of a process group (parallel/sharded_ba.py,
point_sharded_ba.py): given ``all_reduce``, camera-side sums and the cost
are summed over the ranks, and point-side sums too unless
``points_sharded``. Every rank then sees the same cost and the same
camera step, so the fixed-length loops stay in lockstep with no host
sync. Not ported: the chunked solve (``bundle_adjust_two_stage_chunked``),
which exists to interleave programs on the TPU's single stream: on the
card the asynchronous schedules issue the solve on a mapping stream of its
own (streams.py).
"""

from __future__ import annotations

import math

import torch

from . import se3

CHI2_MONO = 5.991
HUBER_DELTA = math.sqrt(CHI2_MONO)
DX_TOL = 1e-7
CG_RTOL2 = 1e-12  # relative (squared, M-norm) CG residual
_DENSE_MAX_KP = 2_097_152  # K*P block-grid cells
_DENSE_MAX_K = 128         # dense reduced system <= 768 x 768


def _inv3x3(m):
    """Batched closed-form 3x3 inverse via adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ei_fh = e * i - f * h
    fg_di = f * g - d * i
    dh_eg = d * h - e * g
    det = a * ei_fh + b * fg_di + c * dh_eg
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([
        torch.stack([ei_fh, c * h - b * i, b * f - c * e], -1),
        torch.stack([fg_di, a * i - c * g, c * d - a * f], -1),
        torch.stack([dh_eg, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def _residuals(poses, pts, obs_kf, obs_pt, obs_uv, fx, fy, cx, cy):
    """Per-observation residuals e (O, 2), camera Jacobians jc (O, 2, 6),
    point Jacobians jp (O, 2, 3) and depths z (O,)."""
    t = poses[obs_kf]
    r = t[:, :3, :3]
    p = torch.einsum("oij,oj->oi", r, pts[obs_pt]) + t[:, :3, 3]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    e = torch.stack([fx * x * inv_z + cx - obs_uv[:, 0], fy * y * inv_z + cy - obs_uv[:, 1]], -1)
    zero = torch.zeros_like(x)
    j_p3 = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * x * inv_z2], -1),
        torch.stack([zero, fy * inv_z, -fy * y * inv_z2], -1),
    ], -2)  # (O, 2, 3)
    jc = torch.cat([j_p3, j_p3 @ (-se3.hat(p))], -1)
    jp = j_p3 @ r
    return e, jc, jp, z


def _robust_cost(chi2, use_huber: bool):
    if not use_huber:
        return chi2
    lin = 2.0 * HUBER_DELTA * torch.sqrt(torch.clamp(chi2, min=1e-12)) - HUBER_DELTA ** 2
    return torch.where(chi2 > CHI2_MONO, lin, chi2)


def _huber_weight(chi2, use_huber: bool):
    if not use_huber:
        return torch.ones_like(chi2)
    n = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(n <= HUBER_DELTA, torch.ones_like(n), HUBER_DELTA / n)


def _seg_sum(vals, ids, num):
    out = torch.zeros((num,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids, vals)


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly in the reals (err is the
    float32 rounding of s = a + b)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def segment_sum_compensated(vals, ids, num_segments: int, n_chunks: int = 64):
    """Compensated (two-float) segment sum for the normal equations: the
    observations split into `n_chunks` float32 partial segment sums, which
    a TwoSum running-error scan combines, so cross-chunk cancellation and
    dynamic range are kept at about twice float32's precision (plain
    float32 sums lose small addends beside large ones on ill-conditioned
    problems). Pad rows go to a spare segment past the end."""
    pad = (-vals.shape[0]) % n_chunks
    if pad:
        vals = torch.cat([vals, vals.new_zeros((pad,) + vals.shape[1:])])
        ids = torch.cat([ids, ids.new_full((pad,), num_segments)])
    per = vals.shape[0] // n_chunks
    chunk = torch.arange(n_chunks, device=vals.device).repeat_interleave(per)
    partials = _seg_sum(vals, chunk * (num_segments + 1) + ids.long(),
                        n_chunks * (num_segments + 1))
    partials = partials.reshape((n_chunks, num_segments + 1) + vals.shape[1:])[:, :num_segments]
    s = torch.zeros_like(partials[0])
    e = torch.zeros_like(s)
    for c in range(n_chunks):
        s, err = _two_sum(s, partials[c])
        e = e + err
    return s + e


def _damp(h, lam):
    n = h.shape[-1]
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    return h + (lam + 1e-6) * eye[None] * (
        1.0 + torch.diagonal(h, dim1=-2, dim2=-1).mean(-1)[:, None, None])


class _Problem:
    """The observation arrays and the cost of one BA problem (of one
    rank's shard, with `all_reduce`: see _bundle_adjust_impl)."""

    def __init__(self, kf_free, obs_kf, obs_pt, obs_uv, obs_w, obs_valid, fx, fy, cx, cy,
                 use_huber, all_reduce=None, points_sharded: bool = False,
                 compensated: bool = False):
        self.kf_free = kf_free
        self.obs_kf, self.obs_pt = obs_kf.long(), obs_pt.long()
        self.obs_uv, self.obs_w, self.obs_valid = obs_uv, obs_w, obs_valid
        self.cam = tuple(float(v) for v in (fx, fy, cx, cy))
        self.use_huber = use_huber
        self.free_f = kf_free.to(torch.float32)[:, None]
        self.all_reduce = all_reduce
        self.points_sharded = points_sharded
        self.compensated = compensated

    def allr(self, *xs):
        """Sum over the ranks (camera-side quantities, the cost); one
        collective for all of `xs`. Identity on one device."""
        if self.all_reduce is not None:
            flat = self.all_reduce(torch.cat([x.reshape(-1) for x in xs]))
            xs = tuple(p.reshape(x.shape)
                       for p, x in zip(flat.split([x.numel() for x in xs]), xs))
        return xs if len(xs) > 1 else xs[0]

    def allr_pt(self, *xs):
        """Point-side sums: complete on their rank under the point-sharded
        layout (every observation of a point lives with the point), summed
        over the ranks otherwise."""
        if self.points_sharded:
            return xs if len(xs) > 1 else xs[0]
        return self.allr(*xs)

    def seg_sum(self, vals, ids, num):
        """Normal-equation accumulation, two-float when compensated."""
        if self.compensated:
            return segment_sum_compensated(vals, ids, num)
        return _seg_sum(vals, ids, num)

    def residuals(self, poses, pts):
        return _residuals(poses, pts, self.obs_kf, self.obs_pt, self.obs_uv, *self.cam)

    def cost(self, poses, pts):
        e, _, _, _ = self.residuals(poses, pts)
        c = _robust_cost(torch.sum(e * e, -1) * self.obs_w, self.use_huber)
        return self.allr(torch.where(self.obs_valid, c, torch.zeros_like(c)).sum())

    def weighted(self, poses, pts):
        e, jc, jp, _ = self.residuals(poses, pts)
        chi2 = torch.sum(e * e, -1) * self.obs_w
        w = _huber_weight(chi2, self.use_huber) * self.obs_w
        w = torch.where(self.obs_valid, w, torch.zeros_like(w))
        return e, jc, jp, jc * w[:, None, None], jp * w[:, None, None]

    def update(self, poses, pts, dxc, dxp, state):
        """The LM acceptance step, frozen once `done`."""
        lam, cost, done = state
        new_poses = torch.where(self.kf_free[:, None, None], se3.se3_exp(dxc) @ poses, poses)
        new_pts = pts + dxp
        new_cost = self.cost(new_poses, new_pts)
        finite = torch.isfinite(new_cost) & torch.isfinite(dxc).all() & torch.isfinite(dxp).all()
        step_done = (torch.abs(dxc).max() < DX_TOL) & (torch.abs(dxp).max() < DX_TOL)
        if self.all_reduce is not None:
            # dxp is rank-local under the point-sharded layout: finite and
            # done hold only where every rank says so, so that all ranks
            # keep the same state
            votes = self.allr(torch.stack([finite, step_done, torch.ones_like(finite)]).float())
            finite, step_done = votes[0] >= votes[2], votes[1] >= votes[2]
        accept = (new_cost < cost) & finite & ~done
        poses = torch.where(accept, new_poses, poses)
        pts = torch.where(accept, new_pts, pts)
        cost = torch.where(accept, new_cost, cost)
        lam_next = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e4)
        lam = torch.where(done, lam, lam_next)
        return poses, pts, (lam, cost, done | step_done)

    def final_chi2(self, poses, pts):
        e, _, _, z = self.residuals(poses, pts)
        chi2 = torch.sum(e * e, -1) * self.obs_w
        return torch.where(self.obs_valid, chi2, torch.full_like(chi2, math.inf)), z


def _dense_step(prob: _Problem, poses, pts, lam):
    """One dense-Schur LM step: all camera / point / cross blocks from one
    segment sum keyed by kf * P + pt, the reduced camera system formed
    densely and solved exactly. Returns (dxc (K, 6), dxp (P, 3))."""
    k_cams, n_pts = poses.shape[0], pts.shape[0]
    e, jc, jp, jcw, jpw = prob.weighted(poses, pts)
    packed = torch.cat([
        torch.einsum("oia,oib->oab", jcw, jp).reshape(-1, 18),
        torch.einsum("oia,oib->oab", jcw, jc).reshape(-1, 36),
        torch.einsum("oia,oib->oab", jpw, jp).reshape(-1, 9),
        torch.einsum("oia,oi->oa", jcw, e),
        torch.einsum("oia,oi->oa", jpw, e),
    ], dim=1)  # (O, 72): Y(18) Hcc(36) Hpp(9) bc(6) bp(3)
    seg = _seg_sum(packed, prob.obs_kf * n_pts + prob.obs_pt, k_cams * n_pts)
    seg = seg.reshape(k_cams, n_pts, 72)
    y = seg[..., :18].reshape(k_cams, n_pts, 6, 3)
    hcc = seg[..., 18:54].sum(1).reshape(k_cams, 6, 6)
    hpp = seg[..., 54:63].sum(0).reshape(n_pts, 3, 3)
    bc = -seg[..., 63:69].sum(1)
    bp = -seg[..., 69:72].sum(0)
    hcc_d = _damp(hcc, lam)
    hpp_inv = _inv3x3(_damp(hpp, lam))
    yhi = torch.einsum("kpab,pbc->kpac", y, hpp_inv)
    s_cross = torch.einsum("kpac,qpdc->kqad", yhi, y)
    s = torch.diag_embed(hcc_d.permute(1, 2, 0)).permute(2, 3, 0, 1) - s_cross
    b_red = bc - torch.einsum("kpac,pc->ka", yhi, bp)
    n6 = 6 * k_cams
    s_flat = s.permute(0, 2, 1, 3).reshape(n6, n6)
    free6 = prob.kf_free.repeat_interleave(6)
    mask2 = free6[:, None] & free6[None, :]
    s_flat = torch.where(mask2, s_flat, torch.eye(n6, dtype=s_flat.dtype, device=s_flat.device))
    b_flat = b_red.reshape(-1) * free6.to(torch.float32)
    dxc = torch.linalg.solve_ex(s_flat, b_flat[:, None])[0][:, 0].reshape(k_cams, 6) * prob.free_f
    dxp = torch.einsum("pab,pb->pa", hpp_inv, bp - torch.einsum("kpab,ka->pb", y, dxc))
    return dxc, dxp


def _cg_step(prob: _Problem, poses, pts, lam, n_cg: int):
    """One matrix-free LM step: the reduced camera system S dx = b solved
    with n_cg block-Jacobi preconditioned CG iterations, S applied through
    segment sums over the observations. Returns (dxc, dxp)."""
    k_cams, n_pts = poses.shape[0], pts.shape[0]
    free_f = prob.free_f
    okf, opt = prob.obs_kf, prob.obs_pt
    e, jc, jp, jcw, jpw = prob.weighted(poses, pts)
    hcc, bc = prob.allr(prob.seg_sum(torch.einsum("oij,oik->ojk", jcw, jc), okf, k_cams),
                        prob.seg_sum(torch.einsum("oij,oi->oj", jcw, e), okf, k_cams))
    hpp, bp = prob.allr_pt(prob.seg_sum(torch.einsum("oij,oik->ojk", jpw, jp), opt, n_pts),
                           prob.seg_sum(torch.einsum("oij,oi->oj", jpw, e), opt, n_pts))
    bc, bp = -bc, -bp
    hcc_d = _damp(hcc, lam)
    hpp_inv = _inv3x3(_damp(hpp, lam))

    def y_mul(v_p):
        t = torch.einsum("oij,oj->oi", jp, v_p[opt])
        return prob.allr(_seg_sum(torch.einsum("oij,oi->oj", jcw, t), okf, k_cams))

    def yt_mul(v_c):
        t = torch.einsum("oij,oj->oi", jc, v_c[okf])
        return prob.allr_pt(_seg_sum(torch.einsum("oij,oi->oj", jpw, t), opt, n_pts))

    def s_mul(x):
        x = x * free_f
        hx = torch.einsum("kij,kj->ki", hcc_d, x)
        return (hx - y_mul(torch.einsum("pij,pj->pi", hpp_inv, yt_mul(x)))) * free_f

    b_red = (bc - y_mul(torch.einsum("pij,pj->pi", hpp_inv, bp))) * free_f
    eye6 = torch.eye(6, dtype=hcc_d.dtype, device=hcc_d.device)
    m_inv = torch.linalg.inv_ex(torch.where(prob.kf_free[:, None, None], hcc_d, eye6[None]))[0]

    def precond(r):
        return torch.einsum("kij,kj->ki", m_inv, r) * free_f

    x = torch.zeros_like(bc)
    r = b_red
    zv = precond(r)
    p = zv
    rz0 = torch.sum(r * zv)
    zero = torch.zeros_like(rz0)
    for _ in range(n_cg):
        rz = torch.sum(r * zv)
        active = rz > CG_RTOL2 * rz0
        sp = s_mul(p)
        denom = torch.sum(p * sp)
        alpha = torch.where(torch.abs(denom) > 1e-12, rz / denom, zero)
        x2 = x + alpha * p
        r2 = r - alpha * sp
        z2 = precond(r2)
        beta = torch.where(torch.abs(rz) > 1e-12, torch.sum(r2 * z2) / rz, zero)
        p2 = z2 + beta * p
        x = torch.where(active, x2, x)
        r = torch.where(active, r2, r)
        zv = torch.where(active, z2, zv)
        p = torch.where(active, p2, p)
    dxc = x * free_f
    dxp = torch.einsum("pij,pj->pi", hpp_inv, bp - yt_mul(dxc))
    return dxc, dxp


def uses_dense(k_cams: int, n_pts: int) -> bool:
    """Whether bundle_adjust takes the dense Schur solve (True) or the
    preconditioned CG (False) for K cameras and P points as padded."""
    return k_cams * n_pts <= _DENSE_MAX_KP and k_cams <= _DENSE_MAX_K


def _solve(prob: _Problem, poses, pts, n_iters: int, n_cg: int, dense: bool):
    state = (torch.full((), 1e-4, device=poses.device), prob.cost(poses, pts),
             torch.zeros((), dtype=torch.bool, device=poses.device))
    for _ in range(n_iters):
        if dense:
            dxc, dxp = _dense_step(prob, poses, pts, state[0])
        else:
            dxc, dxp = _cg_step(prob, poses, pts, state[0], n_cg)
        poses, pts, state = prob.update(poses, pts, dxc, dxp, state)
    chi2, z = prob.final_chi2(poses, pts)
    return poses, pts, chi2, z


def _bundle_adjust_impl(poses, pts, kf_free, obs_kf, obs_pt, obs_uv, obs_w, obs_valid,
                        fx, fy, cx, cy, n_iters: int = 10, n_cg: int = 25,
                        use_huber: bool = True, all_reduce=None, points_sharded: bool = False,
                        compensated: bool = False):
    """The matrix-free LM: each step's reduced camera system solved with
    n_cg preconditioned CG iterations (bundle_adjust's arguments and
    returns). With `all_reduce` (a function summing a tensor over the ranks
    of a process group) the observations are one rank's shard and the
    camera-side sums and the cost are summed over the ranks; point-side
    sums too, unless `points_sharded` (every observation of the rank's
    points lives on the rank). compensated: the two-float normal
    equations."""
    prob = _Problem(kf_free, obs_kf, obs_pt, obs_uv, obs_w, obs_valid, fx, fy, cx, cy,
                    use_huber, all_reduce=all_reduce, points_sharded=points_sharded,
                    compensated=compensated)
    return _solve(prob, poses, pts, n_iters, n_cg, dense=False)


def bundle_adjust(poses, pts, kf_free, obs_kf, obs_pt, obs_uv, obs_w, obs_valid,
                  fx, fy, cx, cy, n_iters: int = 10, n_cg: int = 25, use_huber: bool = True,
                  compensated: bool = False):
    """Joint camera/point LM with Schur-marginalized points.

    poses (K, 4, 4) float32 Tcw; pts (P, 3); kf_free (K,) bool (False
    cameras held fixed); obs_kf, obs_pt (O,) indices; obs_uv (O, 2);
    obs_w (O,) information 1/sigma^2; obs_valid (O,) bool. The dense Schur
    solve for K * P <= 2M cells and K <= 128, the preconditioned CG
    otherwise (K and P as padded by the caller) and whenever `compensated`
    (the two-float normal equations; the dense path's per-(kf, pt)
    accumulation has a handful of addends per segment and an exact
    reduced solve). Returns (poses, pts, chi2 (O,) with inf at invalid
    observations, z (O,))."""
    prob = _Problem(kf_free, obs_kf, obs_pt, obs_uv, obs_w, obs_valid, fx, fy, cx, cy,
                    use_huber, compensated=compensated)
    dense = not compensated and uses_dense(poses.shape[0], pts.shape[0])
    return _solve(prob, poses, pts, n_iters, n_cg, dense)


def classify_outliers(chi2, z, th: float = CHI2_MONO):
    """Observation outlier mask after a BA stage (reference re-checks
    chi2 > 5.991 or negative depth, src/Optimizer.cc:661-676)."""
    return (chi2 > th) | (z <= 0)


def two_stage(solve, poses, pts, kf_free, obs_kf, obs_pt, obs_uv, obs_w, obs_valid,
              fx, fy, cx, cy, n_iters_a: int = 5, n_iters_b: int = 10, **kw):
    """The reference's local-BA schedule (src/Optimizer.cc:649-699) over a
    solve with bundle_adjust's signature: Huber iterations, drop chi2 >
    5.991 / negative-depth edges, more iterations on the survivors.
    Returns (poses, pts, chi2, z, obs_valid_final), chi2 classified against
    the original validity (1e9 at culled edges)."""
    poses, pts, chi2, z = solve(poses, pts, kf_free, obs_kf, obs_pt, obs_uv, obs_w, obs_valid,
                                fx, fy, cx, cy, n_iters=n_iters_a, use_huber=True, **kw)
    obs_valid2 = obs_valid & ~classify_outliers(chi2, z)
    poses, pts, chi2, z = solve(poses, pts, kf_free, obs_kf, obs_pt, obs_uv, obs_w, obs_valid2,
                                fx, fy, cx, cy, n_iters=n_iters_b, use_huber=False, **kw)
    chi2_all = torch.where(obs_valid, torch.where(torch.isinf(chi2), torch.full_like(chi2, 1e9),
                                                  chi2), torch.full_like(chi2, math.inf))
    return poses, pts, chi2_all, z, obs_valid2


def bundle_adjust_two_stage(poses, pts, kf_free, obs_kf, obs_pt, obs_uv, obs_w, obs_valid,
                            fx, fy, cx, cy, n_iters_a: int = 5, n_iters_b: int = 10,
                            n_cg: int = 25, compensated: bool = False):
    """The two-stage schedule (two_stage) over bundle_adjust."""
    return two_stage(bundle_adjust, poses, pts, kf_free, obs_kf, obs_pt, obs_uv, obs_w,
                     obs_valid, fx, fy, cx, cy, n_iters_a=n_iters_a, n_iters_b=n_iters_b,
                     n_cg=n_cg, compensated=compensated)
