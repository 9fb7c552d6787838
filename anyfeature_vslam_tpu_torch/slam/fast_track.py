"""The tracked frame as one call (port of anyfeature_vslam_tpu/slam/fast_track.py).

``fused_extract_track`` runs extraction (kernel K1 on every level),
keypoint undistortion and ``fused_track_step``: the motion-model guided
search with a reference-keyframe fallback, the local-map search, and up to
three motion-only pose LMs (reference Tracking.cc:619-836). Every guided
search is a launch of kernel K2 on the card; a frame's descriptors are
prepared once (``cuda_match.pack_candidates``: binary ones packed, float
ones with their norms) for the three searches over them.

The JAX package runs the frame as one XLA program with two ``lax.cond``s.
Here it runs eagerly; the motion branch is a Python ``if`` on
``use_motion`` (a host bool: no sync), and the fallback is decided by one
``.item()`` on the motion result, which is the frame's only host sync.
Scatters that JAX writes with ``.at[i].set(..., mode="drop")`` send the
dropped rows to a spare slot past the end, so nothing is read back.
"""

from __future__ import annotations

import torch

from .. import perfcount
from ..ops import camera as cam_ops
from ..ops import cuda_match, pose_opt
from . import frame_ops


def predict_pose(last_pose, prev_pose):
    """Constant-velocity prediction pred = (T_last T_prev^-1) T_last
    (reference src/Tracking.cc:340-350,729-744), on the device.

    The inverse takes R^T for R^-1, as the JAX function does. A float32
    rotation is orthonormal only to rounding, and through R^T the
    prediction's distance from SO(3) is about twice the last pose's plus the
    one before it: along a pipelined chain of dispatches, where each pose
    is the pose LM's update of the previous prediction, it grows by
    1 + sqrt(2) per frame, from 1e-7 to a scaled rotation in about 15
    frames that the pose LM cannot undo (its updates are rotations), and the
    keyframes minted from such poses bend the map. So the predicted
    rotation is projected back onto SO(3) (``on_se3``; the JAX package
    does not)."""
    r, t = last_pose[:3, :3], last_pose[:3, 3]
    r_inv = prev_pose[:3, :3].T
    t_inv = -r_inv @ prev_pose[:3, 3]
    vel_r = r @ r_inv
    vel_t = r @ t_inv + t
    pred = torch.eye(4, dtype=last_pose.dtype, device=last_pose.device)
    pred[:3, :3] = vel_r @ r
    pred[:3, 3] = vel_r @ t + vel_t
    return on_se3(pred)


def on_se3(pose):
    """A copy of the 4x4 pose whose rotation block is the rotation nearest
    to it (its polar factor), by two Newton-Schulz steps r <- r (3 I -
    r^T r) / 2: matmuls only, no host sync; each step squares a near
    rotation's distance from SO(3)."""
    pose = pose.clone()
    r = pose[:3, :3]
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    for _ in range(2):
        r = 0.5 * r @ (3.0 * eye - r.T @ r)
    pose[:3, :3] = r
    return pose


def _scatter_drop(n, idx, valid, values, fill):
    """out[idx[i]] = values[i] where valid[i]; other rows dropped (JAX
    ``.at[idx].set(values, mode="drop")`` with idx = n where invalid)."""
    safe = torch.where(valid, idx, torch.full_like(idx, n))
    out = torch.full((n + 1,) + values.shape[1:], fill, dtype=values.dtype,
                     device=values.device)
    out[safe] = values
    return out[:n]


def fused_track_step(
    f_uv, f_bits, f_size, f_angle, f_valid, f_inv_sigma2,
    last_uv, last_bits, last_size, last_angle, last_match_pt, last_match_pos,
    ref_bits, ref_angle, ref_has, ref_match_pt, ref_match_pos,
    blk_ids, blk_pos, blk_normal, blk_min_dist, blk_max_dist,
    blk_ref_size, blk_ref_dist, blk_bits, blk_valid,
    pred_pose, last_pose, use_motion,
    bounds_lo, bounds_hi,
    fx, fy, cx, cy,
    motion_radius, match_th, min_motion_matches, refkf_ratio,
    local_radius, local_ratio, min_track_inliers,
):
    """Returns (pose, match_pt (N,), n_inliers, visible (P,), track_ok,
    used_motion, match_pos (N, 3)), as the JAX function."""
    n = f_uv.shape[0]
    dev = f_uv.device
    if isinstance(use_motion, torch.Tensor):
        use_motion = bool(use_motion.item())
    # the candidates of the motion search, its retry and the local-map
    # search, prepared once
    f_words = cuda_match.pack_candidates(f_bits)

    ok_a = False
    use_mm = torch.zeros((), dtype=torch.bool, device=dev)
    if use_motion:
        # reference TrackWithMotionModel (:729-790)
        with perfcount.span("track.motion"):
            has_pt = last_match_pt >= 0
            pc = last_match_pos @ pred_pose[:3, :3].T + pred_pose[:3, 3]
            z = pc[:, 2]
            zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
            u = fx * pc[:, 0] / zs + cx
            v = fy * pc[:, 1] / zs + cy
            uv_proj = torch.stack([u, v], -1)
            proj_valid = (has_pt & (z > 0) & (u >= bounds_lo[0]) & (u < bounds_hi[0])
                          & (v >= bounds_lo[1]) & (v < bounds_hi[1]))
            uv_proj = torch.where(torch.isfinite(uv_proj), uv_proj, torch.zeros_like(uv_proj))
            res_mm = frame_ops.match_frame_to_frame_2r(
                last_uv, last_bits, last_size, has_pt, uv_proj, proj_valid,
                f_uv, f_bits, f_size, f_valid, last_angle, f_angle,
                motion_radius, match_th, min_motion_matches, f_words,
            )
            mm_pt = _scatter_drop(n, res_mm["idx"], res_mm["valid"], last_match_pt, -1)
            mm_pos = _scatter_drop(n, res_mm["idx"], res_mm["valid"], last_match_pos, 0.0)
            mask_a = (mm_pt >= 0) & f_valid
        with perfcount.span("track.pose_lm"):
            pose_a, inl_a, n_in_a = pose_opt.pose_optimize(
                pred_pose, mm_pos, f_uv, f_inv_sigma2, mask_a, fx, fy, cx, cy)
        ok_a_t = (res_mm["n_matches"] >= min_motion_matches) & (n_in_a >= min_track_inliers)
        with perfcount.span("track.motion_sync"):
            ok_a = bool(ok_a_t.item())  # the frame's one host sync
        pose1, pt1, pos1 = pose_a, torch.where(inl_a, mm_pt, torch.full_like(mm_pt, -1)), mm_pos
        track_ok1 = use_mm = ok_a_t
    if not ok_a:
        # reference TrackReferenceKeyFrame (:619-661)
        with perfcount.span("track.refkf"):
            res_rk = frame_ops.match_descriptors_global(
                f_bits, f_valid, f_angle, ref_bits, ref_has, ref_angle, match_th, refkf_ratio)
            rk_pt = torch.where(res_rk["valid"], ref_match_pt[res_rk["idx"]],
                                torch.full((n,), -1, dtype=ref_match_pt.dtype, device=dev))
            rk_pos = ref_match_pos[res_rk["idx"]]
            mask_b = (rk_pt >= 0) & f_valid
        with perfcount.span("track.pose_lm"):
            pose_b, inl_b, n_in_b = pose_opt.pose_optimize(
                last_pose, rk_pos, f_uv, f_inv_sigma2, mask_b, fx, fy, cx, cy)
        track_ok1 = (res_rk["valid"].sum() >= 15) & (n_in_b >= min_track_inliers)
        pose1, pt1, pos1 = pose_b, torch.where(inl_b, rk_pt, torch.full_like(rk_pt, -1)), rk_pos

    # local-map round (reference TrackLocalMap :792-836); block points
    # already matched this frame are excluded
    with perfcount.span("track.local_map"):
        # a dense (P, N) comparison, as in JAX: torch.isin synchronises on CUDA
        pt1_safe = torch.where(pt1 >= 0, pt1, torch.full_like(pt1, -2))
        already = (blk_ids[:, None] == pt1_safe[None, :]).any(dim=1)
        res_lm = frame_ops.project_and_match(
            blk_pos, blk_normal, blk_min_dist, blk_max_dist, blk_ref_size, blk_ref_dist,
            blk_bits, blk_valid & ~already, pose1, fx, fy, cx, cy, bounds_lo, bounds_hi,
            f_uv, f_bits, f_size, f_valid, local_radius, match_th, local_ratio, f_words,
        )
        add_pt = _scatter_drop(n, res_lm["idx"], res_lm["valid"], blk_ids.to(torch.int32), -1)
        add_pos = _scatter_drop(n, res_lm["idx"], res_lm["valid"], blk_pos, 0.0)
        take = (pt1 < 0) & (add_pt >= 0)
        pt2 = torch.where(take, add_pt, pt1)
        pos2 = torch.where(take[:, None], add_pos, pos1)
        mask2 = (pt2 >= 0) & f_valid
    with perfcount.span("track.pose_lm"):
        pose2, inl2, n_in2 = pose_opt.pose_optimize(
            pose1, pos2, f_uv, f_inv_sigma2, mask2, fx, fy, cx, cy)
    final_pt = torch.where(inl2 & mask2, pt2, torch.full_like(pt2, -1))
    return pose2, final_pt, n_in2, res_lm["visible"], track_ok1, use_mm, pos2


def fused_extract_track(img8, cam, extractor, *track_args, **track_kwargs):
    """Extraction + undistortion + ``fused_track_step`` for one frame.

    img8: (H, W) uint8 (or float) image on the extractor's device; cam: the
    port's CameraParams; extractor: a ``FeatureExtractor``. The remaining
    arguments are those of ``fused_track_step`` after the six current-frame
    feature arrays. Returns (feats dict, track outputs)."""
    with perfcount.span("track.extract"):
        feats = extractor(img8.to(torch.float32))
        feats["uv_und"] = cam_ops.undistort_points(cam, feats["xy"]).to(torch.float32)
    out = fused_track_step(
        feats["uv_und"], feats["desc_bits"], feats["size"], feats["angle"],
        feats["valid"], feats["inv_sigma2"], *track_args, **track_kwargs,
    )
    return feats, out
