"""Frame-level searches and the mapping's batched programs (port of
anyfeature_vslam_tpu/slam/frame_ops.py).

Every guided search goes through ``matching.guided_best_two``, so on the
card each one is a launch of kernel K2: the tracked frame's searches, the
initialization search, the fusion searches, and the relocalization and
loop-closing searches. The searches over one keypoint set take
``f_words``, its descriptors prepared once by the caller
(``cuda_match.pack_candidates``: binary ones packed, float ones with
their norms); without them the search prepares its candidates itself.
The triangulation search and the stereo row search
(``match_stereo_rows``) are dense masked Hamming (binary) or squared-L2
(float) matrices, as in the JAX package: neither gate is K2's window
gate. Frustum
check: Frame::isInFrustum (reference src/Frame.cc:276-331); searches:
SearchByProjection and its frame-to-frame form (reference
src/FeatureMatcher.cc:73-154, :1291-1404), the Sim3-guided form of loop
closing (:287-397, :1066-1289).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_match, matching, triangulation

MAX_SIZE = 1.2 ** 7  # normalized keypoint size range upper bound


def project_points(pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_ref_size,
                   pt_ref_dist, t_cw, fx, fy, cx, cy, bound_lo, bound_hi):
    """Frustum check + projection of map points into a frame: positive
    depth, inside the undistorted bounds, distance within the scale band,
    viewing cos > 0.5. Returns (uv, dist, viewcos, pred_size, visible)."""
    r = t_cw[:3, :3]
    t = t_cw[:3, 3]
    pc = pt_pos @ r.T + t
    z = pc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * pc[:, 0] / zs + cx
    v = fy * pc[:, 1] / zs + cy
    uv = torch.stack([u, v], -1)
    cam_center = -r.T @ t
    po = pt_pos - cam_center[None, :]
    dist = torch.linalg.norm(po, dim=-1)
    viewcos = torch.sum(po * pt_normal, -1) / torch.clamp(
        dist * torch.linalg.norm(pt_normal, dim=-1), min=1e-9)
    in_img = (u >= bound_lo[0]) & (u < bound_hi[0]) & (v >= bound_lo[1]) & (v < bound_hi[1])
    visible = ((z > 0) & in_img & (dist >= pt_min_dist) & (dist <= pt_max_dist)
               & (viewcos > 0.5))
    pred_size = pt_ref_size * pt_ref_dist / torch.clamp(dist, min=1e-9)
    return uv, dist, viewcos, pred_size, visible


def _disabled(mask, radius):
    """Per-query radius, -1 where the query row is disabled."""
    return torch.where(mask, radius, torch.full_like(radius, -1.0))


def match_by_projection(pt_uv, pt_pred_size, pt_viewcos, pt_bits, pt_visible,
                        f_uv, f_bits, f_size, f_valid, base_radius, match_th, ratio,
                        f_words=None):
    """Map points -> frame keypoints: window base_radius * RadiusByViewingCos
    * predicted size * radius scale, size band around the prediction,
    ratio test. Returns dict(idx, dist, valid) over points."""
    r_view = torch.where(pt_viewcos > 0.998, 2.5, 4.0)
    size_q = torch.clamp(pt_pred_size, 1.0, MAX_SIZE)
    # base_radius * RADIUS_SCALE rounded in float32, as the jitted JAX code
    scale = float(np.float32(base_radius) * np.float32(matching.RADIUS_SCALE))
    radius = scale * r_view * size_q
    best, idx, second = matching.guided_best_two(
        pt_bits, f_bits, pt_uv, f_uv, _disabled(pt_visible, radius),
        size_q / 1.5, size_q * 1.5, f_size, f_valid, c_words=f_words,
    )
    return matching.finish_match(best, idx, second, f_bits.shape[0], match_th,
                                 ratio=ratio, unique=True)


def match_frame_to_frame(uv_last, bits_last, size_last, has_pt_last, uv_proj, proj_valid,
                         f_uv, f_bits, f_size, f_valid, angle_last, angle_cur_of_frame,
                         radius, match_th, f_words=None):
    """Motion-model search: last frame's keypoints with map points, at their
    projections in the current frame; rotation-consistency filtered."""
    radius_q = radius * torch.clamp(size_last, 1.0, MAX_SIZE)
    best, idx, second = matching.guided_best_two(
        bits_last, f_bits, uv_proj, f_uv, _disabled(has_pt_last & proj_valid, radius_q),
        size_last / 1.5, size_last * 1.5, f_size, f_valid, c_words=f_words,
    )
    return matching.finish_match(best, idx, second, f_bits.shape[0], match_th,
                                 angle_q=angle_last, angle_c=angle_cur_of_frame, unique=True)


def match_frame_to_frame_2r(uv_last, bits_last, size_last, has_pt_last, uv_proj, proj_valid,
                            f_uv, f_bits, f_size, f_valid, angle_last, angle_cur_of_frame,
                            radius, match_th, min_matches, f_words=None):
    """Motion-model search at radius and 2 * radius (reference widen-and-
    retry, src/Tracking.cc:747-757); the narrow result wins when it has at
    least min_matches. Chosen on the device: no host sync."""
    args = (uv_last, bits_last, size_last, has_pt_last, uv_proj, proj_valid,
            f_uv, f_bits, f_size, f_valid, angle_last, angle_cur_of_frame)
    res1 = match_frame_to_frame(*args, radius, match_th, f_words)
    res2 = match_frame_to_frame(*args, 2.0 * radius, match_th, f_words)
    use1 = res1["valid"].sum() >= min_matches
    res = {k: torch.where(use1, res1[k], res2[k]) for k in res1}
    res["n_matches"] = res["valid"].sum()
    return res


def project_and_match(pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_ref_size,
                      pt_ref_dist, pt_bits, pt_valid, t_cw, fx, fy, cx, cy,
                      bound_lo, bound_hi, f_uv, f_bits, f_size, f_valid,
                      base_radius, match_th, ratio, f_words=None):
    """SearchLocalPoints (reference src/Tracking.cc:988-1028): frustum
    projection + guided projection search. Returns the match dict plus the
    visibility mask."""
    uv, _, viewcos, pred_size, visible = project_points(
        pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_ref_size, pt_ref_dist,
        t_cw, fx, fy, cx, cy, bound_lo, bound_hi,
    )
    visible = visible & pt_valid
    res = match_by_projection(uv, pred_size, viewcos, pt_bits, visible,
                              f_uv, f_bits, f_size, f_valid, base_radius, match_th, ratio,
                              f_words)
    res["visible"] = visible
    return res


def match_for_initialization(uv1, bits1, oct1, angle1, valid1, uv2, bits2, oct2, angle2,
                             valid2, window, match_th, ratio):
    """Windowed search of level-0 keypoints with ratio and rotation checks
    (reference SearchForInitialization, src/FeatureMatcher.cc:399-557): one
    K2 launch on the card (plus the pack of frame 2's descriptors)."""
    nq = uv1.shape[0]
    zero = torch.zeros(nq, device=uv1.device)
    best, idx, second = matching.guided_best_two(
        bits1, bits2, uv1, uv2,
        _disabled(valid1 & (oct1 == 0), torch.full_like(zero, float(window))),
        zero, torch.full_like(zero, matching.INF), torch.ones_like(uv2[:, 0]),
        valid2 & (oct2 == 0),
    )
    return matching.finish_match(best, idx, second, bits2.shape[0], match_th, ratio=ratio,
                                 angle_q=angle1, angle_c=angle2, unique=True)


def match_stereo_rows(bits_l, uv_l, size_l, valid_l, bits_r, uv_r, size_r, valid_r,
                      match_th, min_disp, max_disp):
    """Rectified stereo, left against right keypoints in one masked
    distance matrix (reference Frame::ComputeStereoMatches,
    src/Frame.cc:465, by per-row candidate lists): the row band |v_l -
    v_r| <= max(2 size_r, 2), min_disp < disparity < max_disp, the
    descriptor threshold, a 0.9 ratio and one left keypoint per right
    one. Returns dict(idx, dist, valid, disparity) over left keypoints
    (disparity -1 where no match)."""
    dist = matching.descriptor_distance_matrix(bits_l, bits_r)
    dv = torch.abs(uv_l[:, None, 1] - uv_r[None, :, 1])
    band = torch.clamp(2.0 * size_r[None, :], min=2.0)
    disp = uv_l[:, None, 0] - uv_r[None, :, 0]
    mask = (valid_l[:, None] & valid_r[None, :] & (dv <= band) & (disp > min_disp)
            & (disp < max_disp))
    res = matching.match(dist, mask, match_th, ratio=0.9, unique=True)
    disparity = uv_l[:, 0] - uv_r[res["idx"], 0]
    res["disparity"] = torch.where(res["valid"], disparity, torch.full_like(disparity, -1.0))
    return res


SUBPIX_W = 5   # reference Frame.cc:566-620: 11x11 SAD window (w = 5)
SUBPIX_L = 5   # the window slides +-L columns around the match


def match_stereo_rows_subpix(img_l, img_r, bits_l, uv_l, size_l, valid_l, bits_r, uv_r,
                             size_r, valid_r, match_th, min_disp, max_disp):
    """``match_stereo_rows``, then each match refined to sub-pixel: an 11x11
    window, centre-normalized (its centre intensity subtracted), slid
    +-5 columns around the matched right keypoint, and a parabola through
    the best SAD and its neighbours (reference ComputeStereoMatches,
    src/Frame.cc:566-620). As in the JAX package the SAD runs on the
    full-resolution images (the reference correlates on the keypoint's
    pyramid level), and a match whose refined disparity leaves the range
    is dropped. Returns dict(idx, dist, valid, disparity)."""
    res = match_stereo_rows(bits_l, uv_l, size_l, valid_l, bits_r, uv_r, size_r, valid_r,
                            match_th, min_disp, max_disp)
    h, w_img = img_l.shape
    dev = uv_l.device
    # torch.round, as jnp.round, rounds half to even
    xl = torch.round(uv_l[:, 0]).to(torch.int64)
    yl = torch.round(uv_l[:, 1]).to(torch.int64)
    xr = torch.round(uv_r[res["idx"], 0]).to(torch.int64)
    off = torch.arange(-SUBPIX_W, SUBPIX_W + 1, device=dev)
    ly = torch.clamp(yl[:, None, None] + off[None, :, None], 0, h - 1)
    lx = torch.clamp(xl[:, None, None] + off[None, None, :], 0, w_img - 1)
    patch_l = img_l[ly, lx]                                   # (N, 11, 11)
    patch_l = patch_l - patch_l[:, SUBPIX_W:SUBPIX_W + 1, SUBPIX_W:SUBPIX_W + 1]
    slides = torch.arange(-SUBPIX_L, SUBPIX_L + 1, device=dev)
    rx = torch.clamp(xr[:, None, None, None] + slides[None, :, None, None]
                     + off[None, None, None, :], 0, w_img - 1)    # (N, 11s, 1, 11)
    ry = torch.clamp(yl[:, None, None, None] + off[None, None, :, None], 0, h - 1)
    patch_r = img_r[ry, rx]                                   # (N, 11s, 11, 11)
    patch_r = patch_r - patch_r[:, :, SUBPIX_W:SUBPIX_W + 1, SUBPIX_W:SUBPIX_W + 1]
    sad = torch.sum(torch.abs(patch_r - patch_l[:, None, :, :]), dim=(-2, -1))
    best = torch.argmin(sad, dim=1)  # the first minimum, as jnp.argmin
    interior = (best > 0) & (best < 2 * SUBPIX_L)
    bc = torch.clamp(best, 1, 2 * SUBPIX_L - 1)
    s_prev = torch.gather(sad, 1, (bc - 1)[:, None])[:, 0]
    s_best = torch.gather(sad, 1, bc[:, None])[:, 0]
    s_next = torch.gather(sad, 1, (bc + 1)[:, None])[:, 0]
    denom = s_prev - 2.0 * s_best + s_next
    delta = torch.where(torch.abs(denom) > 1e-9, (s_prev - s_next) / (2.0 * denom),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    corr = torch.where(interior, (bc - SUBPIX_L).to(delta.dtype) + delta,
                       torch.zeros_like(delta))
    disp = uv_l[:, 0] - (xr.to(torch.float32) + corr)
    ok = res["valid"] & (disp > min_disp) & (disp < max_disp)
    res["disparity"] = torch.where(ok, disp, torch.full_like(disp, -1.0))
    res["valid"] = ok
    return res


def match_for_triangulation(bits1, uv1, valid1, bits2, uv2, valid2, oct2_sigma2, f12,
                            epipole2, match_th, ratio):
    """Epipolar-constrained matching between two keyframes (reference
    SearchForTriangulation + CheckDistEpipolarLine, src/FeatureMatcher.cc:
    662-792, :165-182): kp2 within 3.84 sigma^2 of kp1's epipolar line and
    at least 10 * size from the epipole. A dense masked Hamming matrix and
    ``matching.match``, as in the JAX package (not a Pallas kernel there)."""
    p1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=-1)
    lines = p1 @ f12.T
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * uv2[None, :, 0] + b * uv2[None, :, 1] + c
    d2 = num * num / torch.clamp(a * a + b * b, min=1e-12)
    epi_ok = d2 < 3.84 * oct2_sigma2[None, :]
    de2 = (uv2[:, 0] - epipole2[0]) ** 2 + (uv2[:, 1] - epipole2[1]) ** 2
    far_from_epipole = de2 >= 100.0 * torch.sqrt(oct2_sigma2)
    dist = matching.descriptor_distance_matrix(bits1, bits2)
    mask = epi_ok & far_from_epipole[None, :] & valid1[:, None] & valid2[None, :]
    return matching.match(dist, mask, match_th, ratio=ratio, unique=True)


TRI_CHI2 = 5.991
COS_PARALLAX_MAX = 0.9998
SCALE_CONSISTENCY_FACTOR = 1.8   # ~1.5 * scaleFactor (reference ratioFactor)


def _f12_and_epipole(t1, t2, k, k_inv):
    """F12 and the epipole in image 2 from a pose pair (reference
    ComputeF12, src/LocalMapping.cc:557-574)."""
    t21 = t2 @ torch.linalg.inv_ex(t1)[0]
    r, t = t21[:3, :3], t21[:3, 3]
    z = torch.zeros_like(t[0])
    tx = torch.stack([torch.stack([z, -t[2], t[1]]), torch.stack([t[2], z, -t[0]]),
                      torch.stack([-t[1], t[0], z])])
    f12 = k_inv.T @ (tx @ r) @ k_inv
    c1 = -t1[:3, :3].T @ t1[:3, 3]
    e_img = k @ (t2[:3, :3] @ c1 + t2[:3, 3])
    small = torch.abs(e_img[2]) < 1e-9
    ez = torch.where(small, torch.full_like(e_img[2], 1e-9), e_img[2])
    epipole2 = torch.where(small, torch.full_like(e_img[:2], 1e9), e_img[:2] / ez)
    return f12, epipole2


def triangulate_with_neighbors(bits1, uv1, valid1, inv_sigma2_1, size1,
                               bits2_t, uv2_t, valid2_t, size2_t, inv_sigma2_2t,
                               t1, t2_t, k, match_th, ratio):
    """CreateNewMapPoints against T covisible neighbors (reference
    src/LocalMapping.cc:231-473): per neighbor, in covisibility order, the
    epipolar search, linear triangulation and the cheirality / parallax /
    reprojection / scale-consistency gates. The neighbor inputs are
    sequences of T per-keyframe tensors; t2_t is (T, 4, 4).

    The neighbors run in sequence (the JAX ``lax.scan``), carrying the
    current keyframe's unmatched mask: a keypoint claimed by a neighbor is
    not offered to the later ones, which frees their other candidates.
    Returns (idx2 (T, N), pts (T, N, 3), good (T, N))."""
    k_inv = torch.linalg.inv_ex(k)[0]
    c1 = -t1[:3, :3].T @ t1[:3, 3]
    p1 = k @ t1[:3]
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    pc1_r, pc1_t = t1[:3, :3], t1[:3, 3]

    def reproj2(pc, uv):
        z = torch.where(torch.abs(pc[:, 2]) < 1e-9, torch.full_like(pc[:, 2], 1e-9), pc[:, 2])
        return (fx * pc[:, 0] / z + cx - uv[:, 0]) ** 2 + (fy * pc[:, 1] / z + cy - uv[:, 1]) ** 2

    out_idx, out_pts, out_good = [], [], []
    carry = valid1
    for j in range(len(bits2_t)):
        t2 = t2_t[j]
        size2 = size2_t[j]
        f12, epipole2 = _f12_and_epipole(t1, t2, k, k_inv)
        res = match_for_triangulation(bits1, uv1, carry, bits2_t[j], uv2_t[j], valid2_t[j],
                                      size2 * size2, f12, epipole2, match_th, ratio)
        idx = res["idx"]
        uvb = uv2_t[j][idx]
        pts = triangulation.triangulate_linear3(p1, k @ t2[:3], uv1, uvb)
        c2 = -t2[:3, :3].T @ t2[:3, 3]
        finite = torch.isfinite(pts).all(-1)
        pts = torch.where(finite[:, None], pts, torch.zeros_like(pts))
        ray1, ray2 = pts - c1, pts - c2
        d1 = torch.linalg.norm(ray1, dim=-1)
        d2 = torch.linalg.norm(ray2, dim=-1)
        cosp = torch.sum(ray1 * ray2, -1) / torch.clamp(d1 * d2, min=1e-12)
        pc1 = pts @ pc1_r.T + pc1_t
        pc2 = pts @ t2[:3, :3].T + t2[:3, 3]
        e1 = reproj2(pc1, uv1) * inv_sigma2_1
        e2 = reproj2(pc2, uvb) * inv_sigma2_2t[j][idx]
        ratio_dist = d2 / torch.clamp(d1, min=1e-12)
        ratio_size = size1 / torch.clamp(size2[idx], min=1e-12)
        scale_ok = ((ratio_dist < ratio_size * SCALE_CONSISTENCY_FACTOR)
                    & (ratio_dist * SCALE_CONSISTENCY_FACTOR > ratio_size))
        good = (res["valid"] & finite & (cosp < COS_PARALLAX_MAX) & (cosp > 0)
                & (pc1[:, 2] > 0) & (pc2[:, 2] > 0) & (e1 < TRI_CHI2) & (e2 < TRI_CHI2)
                & scale_ok)
        carry = carry & ~good
        out_idx.append(idx)
        out_pts.append(pts)
        out_good.append(good)
    return torch.stack(out_idx), torch.stack(out_pts), torch.stack(out_good)


def fuse_points_into_targets(pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_ref_size,
                             pt_ref_dist, pt_bits, pt_valid_t, t_cw_t, f_uv_t, f_bits_t,
                             f_size_t, f_valid_t, fx, fy, cx, cy, bound_lo, bound_hi,
                             base_radius, match_th, f_words_t=None):
    """One source point set projected into T target keyframes (reference
    SearchInNeighbors, src/LocalMapping.cc:475-555, calling Fuse,
    src/FeatureMatcher.cc:794-942): a loop of T searches, each one K2
    launch on the card. The target inputs are sequences of T per-keyframe
    tensors (f_words_t: their prepared descriptors, if the caller has them);
    pt_valid_t is (T, P). Returns (idx (T, P), valid (T, P))."""
    idx_t, valid_t = [], []
    for j in range(len(f_uv_t)):
        uv, _, viewcos, pred_size, visible = project_points(
            pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_ref_size, pt_ref_dist,
            t_cw_t[j], fx, fy, cx, cy, bound_lo, bound_hi)
        res = match_by_projection(
            uv, pred_size, viewcos, pt_bits, visible & pt_valid_t[j], f_uv_t[j], f_bits_t[j],
            f_size_t[j], f_valid_t[j], base_radius, match_th, None,
            None if f_words_t is None else f_words_t[j])
        idx_t.append(res["idx"])
        valid_t.append(res["valid"])
    return torch.stack(idx_t), torch.stack(valid_t)


def fuse_target_points_into_kf(pt_pos_t, pt_normal_t, pt_min_dist_t, pt_max_dist_t,
                               pt_ref_size_t, pt_ref_dist_t, pt_bits_t, pt_valid_t, t_cw,
                               f_uv, f_bits, f_size, f_valid, fx, fy, cx, cy, bound_lo,
                               bound_hi, base_radius, match_th, f_words=None):
    """The reverse fuse direction (reference SearchInNeighbors second half,
    src/LocalMapping.cc:516-545): T neighbor keyframes' point sets, each
    (T, P, ...), projected into one keyframe, one K2 launch per neighbor on
    the card, all on the keyframe's descriptors prepared once. Returns (idx
    (T, P), valid (T, P))."""
    if f_words is None:
        f_words = cuda_match.pack_candidates(f_bits)
    idx_t, valid_t = [], []
    for j in range(pt_pos_t.shape[0]):
        uv, _, viewcos, pred_size, visible = project_points(
            pt_pos_t[j], pt_normal_t[j], pt_min_dist_t[j], pt_max_dist_t[j], pt_ref_size_t[j],
            pt_ref_dist_t[j], t_cw, fx, fy, cx, cy, bound_lo, bound_hi)
        res = match_by_projection(
            uv, pred_size, viewcos, pt_bits_t[j], visible & pt_valid_t[j], f_uv, f_bits,
            f_size, f_valid, base_radius, match_th, None, f_words)
        idx_t.append(res["idx"])
        valid_t.append(res["valid"])
    return torch.stack(idx_t), torch.stack(valid_t)


def match_descriptors_global(bits_q, valid_q, angle_q, bits_c, valid_c, angle_c,
                             match_th, ratio, words_c=None):
    """Unconstrained descriptor matching with ratio + rotation consistency
    (stands in for SearchByBoW, reference src/FeatureMatcher.cc:186-283).
    words_c: the candidates' prepared descriptors, if the caller has them."""
    dev = bits_q.device
    nq, nc = bits_q.shape[0], bits_c.shape[0]
    zuv = torch.zeros((nq, 2), device=dev)
    zcuv = torch.zeros((nc, 2), device=dev)
    best, idx, second = matching.guided_best_two(
        bits_q, bits_c, zuv, zcuv,
        torch.where(valid_q, torch.full((nq,), matching.INF, device=dev),
                    torch.full((nq,), -1.0, device=dev)),
        torch.zeros(nq, device=dev), torch.full((nq,), matching.INF, device=dev),
        torch.ones(nc, device=dev), valid_c, c_words=words_c,
    )
    return matching.finish_match(best, idx, second, nc, match_th, ratio=ratio,
                                 angle_q=angle_q, angle_c=angle_c, unique=True)


def match_descriptors_to_many(bits_q, valid_q, angle_q, bits_c, valid_c, angle_c, match_th,
                              ratio, words_c=None):
    """The frame's descriptors against C candidate keyframes (relocalization;
    the reference loops SearchByBoW per candidate, src/Tracking.cc:1190-1210,
    the JAX package vmaps ``match_descriptors_global``): one K2 launch per
    candidate on the card. bits_c, valid_c, angle_c: sequences of C
    per-keyframe tensors; words_c: their prepared descriptors where the
    caller has them (else each search prepares its candidates). Returns
    dict(idx, dist, valid), each (C, Nq)."""
    out = [match_descriptors_global(bits_q, valid_q, angle_q, bits_c[i], valid_c[i], angle_c[i],
                                    match_th, ratio, None if words_c is None else words_c[i])
           for i in range(len(bits_c))]
    return {k: torch.stack([o[k] for o in out]) for k in out[0]}


def match_loop_projection(pt_uv, pt_pred_size, pt_bits, pt_visible, f_uv, f_bits, f_size,
                          f_valid, th_radius, match_th, f_words=None):
    """Sim3-guided projection search of loop closing (reference
    SearchByProjection(KF, Scw, points, matched, th),
    src/FeatureMatcher.cc:287-397, and each direction of SearchBySim3,
    :1066-1289): window th * predicted size, size band, distance
    threshold, no ratio test. One K2 launch on the card."""
    size_q = torch.clamp(pt_pred_size, 1.0, MAX_SIZE)
    best, idx, second = matching.guided_best_two(
        pt_bits, f_bits, pt_uv, f_uv, _disabled(pt_visible, th_radius * size_q),
        size_q / 1.5, size_q * 1.5, f_size, f_valid, c_words=f_words,
    )
    return matching.finish_match(best, idx, second, f_bits.shape[0], match_th, ratio=None,
                                 unique=True)
