"""FAST-9/16 corner score and 3x3 NMS in plain PyTorch (port of
anyfeature_vslam_tpu/frontend/fast.py).

This is the plain twin of kernel K1 (``frontend/cuda_fast.py``): the
extractor reaches it only for CPU tensors, and the tests and chip_smoke.py
hold the kernel against it. Every step is a float subtract, compare or
min/max, so it equals the JAX version (and the kernel) bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (dy, dx), clockwise from (-3, 0).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # FAST-9: at least 9 contiguous ring pixels brighter/darker


def fast_score_map(img, threshold: float):
    """FAST "V" strength over an (H, W) float32 image, 3-px border zeroed.

    For each of the 16 contiguous 9-arcs, the minimum of (ring - centre)
    over the arc; the bright score is the max of that over arcs, the dark
    score the same on (centre - ring). A side counts only when strictly
    above the threshold (then its best arc is all-bright / all-dark).
    """
    h, w = img.shape
    padded = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    d = torch.stack([
        padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img for dy, dx in CIRCLE_OFFSETS
    ])  # (16, H, W)
    ext = torch.cat([d, d[:ARC_LEN - 1]], 0)
    arc_min = ext[0:16]
    arc_max = ext[0:16]
    for k in range(1, ARC_LEN):
        arc_min = torch.minimum(arc_min, ext[k:k + 16])
        arc_max = torch.maximum(arc_max, ext[k:k + 16])
    s_b = arc_min.amax(0)
    s_d = -arc_max.amin(0)
    zero = torch.zeros_like(s_b)
    score = torch.maximum(torch.where(s_b > threshold, s_b, zero),
                          torch.where(s_d > threshold, s_d, zero))
    interior = torch.zeros_like(score, dtype=torch.bool)
    interior[3:h - 3, 3:w - 3] = True
    return torch.where(interior, score, zero)


def nms3x3(score):
    """3x3 non-maximum suppression keeping ties (>=) and score > 0."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= neigh) & (score > 0.0), score, torch.zeros_like(score))
