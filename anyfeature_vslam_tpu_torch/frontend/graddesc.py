"""The rotated sampling grid of the gradient-histogram descriptors (the
part of anyfeature_vslam_tpu/frontend/graddesc.py that learned48 uses).

A 20x20 grid at one-pixel spacing, rotated to each of ``N_ROT`` steps and
bilinearly sampled from a 31x31 patch, is one constant (961, N_ROT * 400)
matrix: column r * 400 + s samples grid point s at step r. Numpy, copied
from the JAX package (a CPU test holds it equal). ``describe_grad`` and the
cell histograms wait for the surf64 / kaze64 / sift128 families
(ROADMAP.md queue item 9).
"""

from __future__ import annotations

import functools

import numpy as np

PATCH = 20          # samples per side (covering a 20x20 rotated window)
_SPACING = 1.0      # sample spacing in pixels at the keypoint's level
N_ROT = 16          # rotation quantization steps (22.5 deg)
PATCH_RADIUS = 15   # gathered patch half-size
_P = 2 * PATCH_RADIUS + 1
_N_SAMP = PATCH * PATCH


def _grid():
    half = (PATCH - 1) / 2.0
    ys, xs = np.mgrid[0:PATCH, 0:PATCH].astype(np.float32)
    return (xs - half) * _SPACING, (ys - half) * _SPACING


@functools.cache
def _sample_matrix():
    """Constant (961, N_ROT * 400) float32 bilinear matrix, built once per
    process (read-only: callers copy it into a tensor)."""
    gx, gy = (g.reshape(-1) for g in _grid())
    m = np.zeros((_P * _P, N_ROT * _N_SAMP), np.float32)
    for r in range(N_ROT):
        th = 2.0 * np.pi * r / N_ROT
        ca, sa = np.cos(th), np.sin(th)
        px = gx * ca - gy * sa
        py = gx * sa + gy * ca
        x = np.clip(px + PATCH_RADIUS, 0.0, _P - 1.001)
        y = np.clip(py + PATCH_RADIUS, 0.0, _P - 1.001)
        x0 = np.floor(x).astype(np.int64)
        y0 = np.floor(y).astype(np.int64)
        fx = x - x0
        fy = y - y0
        cols = r * _N_SAMP + np.arange(_N_SAMP)
        for dy_, dx_, w in (
            (0, 0, (1 - fx) * (1 - fy)),
            (0, 1, fx * (1 - fy)),
            (1, 0, (1 - fx) * fy),
            (1, 1, fx * fy),
        ):
            np.add.at(m, ((y0 + dy_) * _P + (x0 + dx_), cols), w)
    m.flags.writeable = False
    return m
