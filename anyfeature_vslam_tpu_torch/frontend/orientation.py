"""Intensity-centroid keypoint orientation (port of
anyfeature_vslam_tpu/frontend/orientation.py).

Over the radius-15 circular patch, m10 = sum x*I, m01 = sum y*I and the
angle is atan2(m01, m10) (reference IC_Angle, src/ORBextractor.cc:143-178).
The patch gather is a plain index gather; the JAX package's one-hot
matmul gather is a TPU layout trick with the same result.
"""

from __future__ import annotations

import numpy as np
import torch

PATCH_RADIUS = 15
_P = 2 * PATCH_RADIUS + 1


def moment_matrix_np():
    """(961, 2) float32: columns are the circular-masked x and y moment
    weights of a 31x31 patch."""
    ys, xs = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1, -PATCH_RADIUS:PATCH_RADIUS + 1]
    mask = ((ys * ys + xs * xs) <= PATCH_RADIUS * PATCH_RADIUS).astype(np.float32)
    return np.stack([(xs.astype(np.float32) * mask).reshape(-1),
                     (ys.astype(np.float32) * mask).reshape(-1)], axis=1)


def gather_patches(img, xy, radius: int):
    """(N, 2r+1, 2r+1) patches centred on the rounded keypoints of an
    edge-padded level image. xy: (N, 2) float (x, y)."""
    h, w = img.shape
    p = 2 * radius + 1
    xi = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, h - 1)
    offs = torch.arange(p, device=img.device)
    # padded[y + a, x + b] == img[clip(y + a - r), clip(x + b - r)]
    rows = torch.clamp(yi[:, None] + offs[None, :] - radius, 0, h - 1)  # (N, p)
    cols = torch.clamp(xi[:, None] + offs[None, :] - radius, 0, w - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def ic_angle_from_patches(flat, moment_mat):
    """Orientations (N,) from flat patches (N, 961) and the (961, 2)
    moment matrix (fp32 product, TF32 off)."""
    m = flat @ moment_mat
    return torch.atan2(m[:, 1], m[:, 0])


def ic_angle(img, xy, moment_mat):
    """Orientations (N,) of keypoints xy (N, 2) on a level image: the IC
    angle of the radius-15 patches (learned48 takes it on the raw level,
    orb32 on the blurred one)."""
    patches = gather_patches(img, xy, PATCH_RADIUS)
    return ic_angle_from_patches(patches.reshape(patches.shape[0], -1), moment_mat)
