"""Frame-level guided searches of the tracked frame (port of the parts of
anyfeature_vslam_tpu/slam/frame_ops.py that the tracked frame runs).

Every search goes through ``matching.guided_best_two``, so on the card each
one is a launch of kernel K2. The searches over the current frame's
keypoints take ``f_words``, the frame's descriptors packed once by the
caller (``cuda_match.pack_bits``); without them the search packs its
candidates itself, one more launch. Frustum check: Frame::isInFrustum (reference
src/Frame.cc:276-331); searches: SearchByProjection and its frame-to-frame
form (reference src/FeatureMatcher.cc:73-154, :1291-1404).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import matching

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


def match_descriptors_global(bits_q, valid_q, angle_q, bits_c, valid_c, angle_c,
                             match_th, ratio):
    """Unconstrained descriptor matching with ratio + rotation consistency
    (stands in for SearchByBoW, reference src/FeatureMatcher.cc:186-283)."""
    dev = bits_q.device
    nq, nc = bits_q.shape[0], bits_c.shape[0]
    zuv = torch.zeros((nq, 2), device=dev)
    zcuv = torch.zeros((nc, 2), device=dev)
    best, idx, second = matching.guided_best_two(
        bits_q, bits_c, zuv, zcuv,
        torch.where(valid_q, torch.full((nq,), matching.INF, device=dev),
                    torch.full((nq,), -1.0, device=dev)),
        torch.zeros(nq, device=dev), torch.full((nq,), matching.INF, device=dev),
        torch.ones(nc, device=dev), valid_c,
    )
    return matching.finish_match(best, idx, second, nc, match_th, ratio=ratio,
                                 angle_q=angle_q, angle_c=angle_c, unique=True)
