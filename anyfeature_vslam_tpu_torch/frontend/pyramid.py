"""Image pyramid + separable Gaussian blur (port of
anyfeature_vslam_tpu/frontend/pyramid.py).

The resize matrices and blur taps are numpy constants copied from the JAX
package (a CPU test holds them equal); ``frontend/extractor.py`` keeps them
as buffers of its ``FeatureExtractor`` (pyramid) and ``SiftExtractor``
(octave halving, blur taps) modules.
"""

from __future__ import annotations

import numpy as np
import torch


def level_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """Static (h, w) per level, rounded like cv::resize."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor ** lvl)
        shapes.append((max(int(round(height * inv)), 16), max(int(round(width * inv)), 16)))
    return shapes


def resize_weights_np(n_in: int, n_out: int):
    """(n_out, n_in) float32 anti-aliased bilinear resize matrix along one
    axis (half-pixel centres, triangle kernel stretched by the downscale,
    edge renormalisation)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    radius = max(1.0, inv)
    out = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        x = (i + 0.5) * inv - 0.5
        lo = int(np.floor(x - radius))
        hi = int(np.ceil(x + radius)) + 1
        js = np.arange(max(lo, 0), min(hi, n_in))
        t = (js - x) * min(scale, 1.0)
        w = np.maximum(0.0, 1.0 - np.abs(t))
        s = w.sum()
        if s > 0:
            out[i, js] = w / s
    return out


def gaussian_kernel1d(sigma: float, radius: int):
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def build_pyramid(image, resize_mats):
    """image (H, W) float32 -> list of per-level images.

    Cascaded level-to-level like the reference (src/ORBextractor.cc:652):
    level l = Wr_l @ level_{l-1} @ Wc_l^T. ``resize_mats`` is a list of
    (Wr, Wc) pairs for levels 1.., on the image's device. Here they are
    plain fp32 with TF32 off. The JAX package asks for BF16_BF16_F32_X3 in
    these two products: an explicit algorithm, which its package-wide
    ``highest`` default (anyfeature_vslam_tpu/__init__.py:22) does not
    override. On the CPU its levels and the port's differ only in the sum
    order (3e-5 gray levels at most at 320x240, both within 3.1e-5 of a
    float64 product).
    """
    levels = [image]
    for wr, wc in resize_mats:
        levels.append((wr @ levels[-1]) @ wc.T)
    return levels


def gaussian_blur(image, taps):
    """Separable blur with edge replication; ``taps`` is the 1-D float32
    kernel (2r+1 taps) on the image's device. Accumulates tap by tap in the
    same order as the JAX package."""
    radius = (len(taps) - 1) // 2
    h, w = image.shape
    img = torch.cat([image[:1].expand(radius, w), image, image[-1:].expand(radius, w)], 0)
    out = taps[0] * img[0:h]
    for i in range(1, len(taps)):
        out = out + taps[i] * img[i:i + h]
    img = torch.cat([out[:, :1].expand(h, radius), out, out[:, -1:].expand(h, radius)], 1)
    res = taps[0] * img[:, 0:w]
    for i in range(1, len(taps)):
        res = res + taps[i] * img[:, i:i + w]
    return res
