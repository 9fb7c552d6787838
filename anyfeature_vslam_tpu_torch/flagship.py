"""Flagship per-frame step (port of anyfeature_vslam_tpu/flagship.py).

``tracking_step``: orb32 extraction (K1 on every level) -> one guided
search of the previous frame's map points (K2) -> motion-only pose LM.
``tracking_scan``: the step over a stack of frames, each started from the
pose the one before found.
``entry(device="cuda")`` mirrors ``__graft_entry__.entry()``: the step at
640x480 with 1000 features, and example arguments on ``device``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .frontend.extractor import ExtractorConfig, FeatureExtractor
from .ops import matching, pose_opt
from .slam.frame_ops import MAX_SIZE


def tracking_step(image, prev_bits, prev_uv_proj, prev_size, prev_valid, pts3d, t_init,
                  fx, fy, cx, cy, extractor: FeatureExtractor):
    """Full tracking forward step for one frame.

    image: (H, W) float32; prev_bits (M, 256) uint8 descriptors of tracked
    map points; prev_uv_proj (M, 2) their predicted projections; prev_size
    (M,); prev_valid (M,) bool; pts3d (M, 3); t_init (4, 4) predicted pose.
    Returns (pose, n_inliers, feats dict).
    """
    feats = extractor(image)
    radius = 15.0 * matching.RADIUS_SCALE * torch.clamp(prev_size, 1.0, MAX_SIZE)
    best, idx, second = matching.guided_best_two(
        prev_bits, feats["desc_bits"], prev_uv_proj, feats["xy"],
        torch.where(prev_valid, radius, torch.full_like(radius, -1.0)),
        prev_size / 1.5, prev_size * 1.5, feats["size"], feats["valid"],
    )
    res = matching.finish_match(best, idx, second, feats["desc_bits"].shape[0], 75.0,
                                unique=True)
    uv_obs = feats["xy"][res["idx"]]
    inv_s2 = feats["inv_sigma2"][res["idx"]]
    pose, _, n_in = pose_opt.pose_optimize(
        t_init, pts3d, uv_obs, inv_s2, res["valid"] & prev_valid, fx, fy, cx, cy)
    return pose, n_in, feats


def tracking_scan(images, prev_bits, prev_uv_proj, prev_size, prev_valid, pts3d, t_init,
                  fx, fy, cx, cy, extractor: FeatureExtractor):
    """tracking_step over images (N, H, W), frame k + 1 starting from frame
    k's optimized pose (the motion-model chain of reference
    Tracking::TrackWithMotionModel, src/Tracking.cc:729). Returns (poses
    (N, 4, 4), n_inliers (N,))."""
    pose, poses, n_inliers = t_init, [], []
    for image in images:
        pose, n_in, _ = tracking_step(image, prev_bits, prev_uv_proj, prev_size, prev_valid,
                                      pts3d, pose, fx, fy, cx, cy, extractor)
        poses.append(pose)
        n_inliers.append(torch.as_tensor(n_in, device=pose.device))
    return torch.stack(poses), torch.stack(n_inliers)


def make_example(height: int = 480, width: int = 640, n_pts: int = 512, seed: int = 0):
    """Synthetic example inputs (numpy, drawn as the JAX package draws them)."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 255, (height, width)).astype(np.float32)
    bits = rng.integers(0, 2, (n_pts, 256)).astype(np.uint8)
    uv = rng.uniform([0, 0], [width, height], (n_pts, 2)).astype(np.float32)
    size = np.ones(n_pts, np.float32)
    valid = np.ones(n_pts, bool)
    pts3d = rng.uniform([-2, -2, 3], [2, 2, 9], (n_pts, 3)).astype(np.float32)
    t_init = np.eye(4, dtype=np.float32)
    return (
        image, bits, uv, size, valid, pts3d, t_init,
        np.float32(517.3), np.float32(516.5), np.float32(318.6), np.float32(255.3),
    )


def example_on(device, height: int = 480, width: int = 640, **kw):
    """make_example with the arrays as tensors on ``device`` and the
    intrinsics as Python floats."""
    ex = make_example(height, width, **kw)
    arrays = tuple(torch.from_numpy(a).to(device) for a in ex[:7])
    return arrays + tuple(float(v) for v in ex[7:])


def entry(device="cuda"):
    """(fn, example_args) for the step at 640x480, 1000 orb32 features, on
    the card unless the caller names another device (the tests pass
    "cpu")."""
    height, width = 480, 640
    extractor = FeatureExtractor(ExtractorConfig(n_features=1000), height, width).to(device)
    fn = functools.partial(tracking_step, extractor=extractor)
    return fn, example_on(device, height, width)
