"""Blob detection per pyramid level (port of
anyfeature_vslam_tpu/frontend/dog.py): the ``ExtractorConfig.detector``
values other than FAST in the pyramid branch.

Response domains:
  - "dog"     : |g(1.2) - g(2.0)| on raw 0..255 intensity
  - "dog_norm": the same on 0..1-normalized intensity
  - "hessian" : sigma^4 * det(Hessian of g(2.0)) on raw intensity
                (surf64, threshold 100; scalespace.det_hessian_map)

then the threshold and the 3x3 NMS of the FAST detector (fast.nms3x3).
Plain PyTorch; no kernel runs here.
"""

from __future__ import annotations

import torch

from . import pyramid, scalespace
from .fast import nms3x3

SIGMA_A = 1.2
SIGMA_B = 2.0
MODES = ("dog", "dog_norm", "hessian")


def tensors(mode: str):
    """The blur taps ``dog_score_map`` takes for `mode`, as CPU tensors:
    (g(2.0) over radius 6,) for "hessian", else (g(1.2) over radius 3,
    g(2.0) over radius 5)."""
    if mode not in MODES:
        raise ValueError(f"unknown blob detector: {mode} (known: {MODES})")
    if mode == "hessian":
        return (scalespace.taps(SIGMA_B),)
    return (torch.from_numpy(pyramid.gaussian_kernel1d(SIGMA_A, 3)),
            torch.from_numpy(pyramid.gaussian_kernel1d(SIGMA_B, 5)))


def dog_score_map(img, threshold, mode, taps):
    """(H, W) image -> (H, W) blob response, zero below threshold and off
    the 3x3 maxima. taps: ``tensors(mode)`` on the image's device."""
    if mode == "hessian":
        resp = scalespace.det_hessian_map(img, taps[0], sigma=SIGMA_B)
    else:
        if mode == "dog_norm":
            img = img * (1.0 / 255.0)
        ga = pyramid.gaussian_blur(img, taps[0])
        gb = pyramid.gaussian_blur(img, taps[1])
        resp = torch.abs(ga - gb)
    score = torch.where(resp > threshold, resp, torch.zeros_like(resp))
    return nms3x3(score)
