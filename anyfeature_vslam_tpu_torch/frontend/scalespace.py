"""SIFT Gaussian scale space: octave stacks, 3D DoG extrema, subpixel fit,
and the det(Hessian) blob response (port of
anyfeature_vslam_tpu/frontend/scalespace.py).

Each octave is a stack of ``nspo + 3`` Gaussian slices built by
incremental separable blurs; the 26-neighbour extremum test is dense 3x3
max / min pooling over three adjacent DoG slices; the quadratic subpixel
fit solves the 3x3 system H d = -g in closed form (cofactor inverse) per
pixel, with its offsets clamped to [-0.6, 0.6] (the JAX package's single
step; Lowe iterates). The next octave's base is the slice at 2 sigma0
halved by the resize matrices, ``wr @ (img @ wc.T)`` as in JAX.

Plain PyTorch in the JAX package's expression order: every stencil is
elementwise over edge-replicated shifts (``nonlinear._shift``), so the
card and the CPU compute the same values. The blur taps and resize
matrices are numpy constants copied from the JAX package; the extractors
keep them as buffers (``taps``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import pyramid
from .nonlinear import _shift

SIGMA0 = 1.6          # base scale of slice 0 in each octave (Lowe)
ASSUMED_BLUR = 0.5    # camera blur assumed on the input image
EDGE_R = 10.0         # SiftGPU -e 10 (reference Feature_sift128.cpp:44)
MIN_OCTAVE_DIM = 32   # stop descending octaves below this


def _roll_edge(a, dy: int, dx: int):
    """out[y, x] = a[clip(y - dy), clip(x - dx)], edge replicated."""
    return _shift(a, -dy, -dx)


def _pool3x3(a, op):
    r = a
    for dy, dx in ((0, 1), (0, -1)):
        r = op(r, _roll_edge(a, dy, dx))
    c = r
    for dy in (1, -1):
        c = op(c, _roll_edge(r, dy, 0))
    return c


def n_octaves(h: int, w: int, max_octaves: int) -> int:
    n = 1
    while n < max_octaves and min(h, w) // (2 ** n) >= MIN_OCTAVE_DIM:
        n += 1
    return n


def slice_sigmas(nspo: int):
    """Absolute blur of each of the nspo+3 slices within an octave."""
    k = 2.0 ** (1.0 / nspo)
    return [SIGMA0 * (k ** i) for i in range(nspo + 3)]


def blur_radius(sigma: float) -> int:
    return max(int(np.ceil(3.0 * sigma)), 1)


def taps(sigma: float):
    """The JAX package's float32 Gaussian taps at `sigma` over a radius of
    ceil(3 sigma), as a CPU tensor."""
    return torch.from_numpy(pyramid.gaussian_kernel1d(sigma, blur_radius(sigma)))


def base_sigma() -> float:
    """The blur that takes the input image (assumed blur 0.5) to SIGMA0."""
    return float(np.sqrt(SIGMA0 ** 2 - ASSUMED_BLUR ** 2))


def increment_sigmas(nspo: int):
    """sigma_inc = sqrt(s_i^2 - s_{i-1}^2) of slices 1..nspo+2."""
    sig = slice_sigmas(nspo)
    return [float(np.sqrt(sig[i] ** 2 - sig[i - 1] ** 2)) for i in range(1, nspo + 3)]


def build_octave(base, inc_taps):
    """base: (H, W) already blurred to SIGMA0. Returns nspo+3 Gaussian
    slices by incremental blurs; inc_taps: the taps of
    ``increment_sigmas(nspo)`` on base's device."""
    slices = [base]
    for t in inc_taps:
        slices.append(pyramid.gaussian_blur(slices[-1], t))
    return slices


def octave_shape(h: int, w: int):
    """The shape ``downsample2`` halves (h, w) to."""
    return max(h // 2, MIN_OCTAVE_DIM // 2), max(w // 2, MIN_OCTAVE_DIM // 2)


def downsample2(img, wr, wc):
    """Halve both dims: wr (h2, h) and wc (w2, w) are
    ``pyramid.resize_weights_np`` for ``octave_shape``."""
    return wr @ (img @ wc.T)


def dog_extrema_maps(d_prev, d_cur, d_next, contrast_th: float):
    """3D extremum test + edge gate + closed-form subpixel fit for ONE
    inner DoG slice, all dense.

    Returns (score, off_x, off_y, off_s): score > 0 where a keypoint
    candidate survives every gate (|refined D|), offsets in [-0.6, 0.6].
    """
    D = d_cur
    is_max = (
        (D >= _pool3x3(d_cur, torch.maximum))
        & (D >= _pool3x3(d_prev, torch.maximum))
        & (D >= _pool3x3(d_next, torch.maximum))
    )
    is_min = (
        (D <= _pool3x3(d_cur, torch.minimum))
        & (D <= _pool3x3(d_prev, torch.minimum))
        & (D <= _pool3x3(d_next, torch.minimum))
    )
    extremum = (is_max | is_min) & (torch.abs(D) > 0.8 * contrast_th)

    # spatial derivatives of the current slice
    dx = 0.5 * (_roll_edge(D, 0, -1) - _roll_edge(D, 0, 1))
    dy = 0.5 * (_roll_edge(D, -1, 0) - _roll_edge(D, 1, 0))
    ds = 0.5 * (d_next - d_prev)
    dxx = _roll_edge(D, 0, -1) + _roll_edge(D, 0, 1) - 2.0 * D
    dyy = _roll_edge(D, -1, 0) + _roll_edge(D, 1, 0) - 2.0 * D
    dss = d_next + d_prev - 2.0 * D
    dxy = 0.25 * (
        _roll_edge(D, -1, -1) + _roll_edge(D, 1, 1)
        - _roll_edge(D, -1, 1) - _roll_edge(D, 1, -1)
    )
    dxs = 0.25 * (
        (_roll_edge(d_next, 0, -1) - _roll_edge(d_next, 0, 1))
        - (_roll_edge(d_prev, 0, -1) - _roll_edge(d_prev, 0, 1))
    )
    dys = 0.25 * (
        (_roll_edge(d_next, -1, 0) - _roll_edge(d_next, 1, 0))
        - (_roll_edge(d_prev, -1, 0) - _roll_edge(d_prev, 1, 0))
    )

    # edge gate on the 2D Hessian (tr^2/det < (r+1)^2/r, det > 0)
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    edge_ok = (det2 > 0.0) & (
        tr * tr * EDGE_R < (EDGE_R + 1.0) ** 2 * det2
    )

    # closed-form solve of the symmetric 3x3 system H delta = -g
    # via the cofactor (adjugate) inverse
    c00 = dyy * dss - dys * dys
    c01 = dxs * dys - dxy * dss
    c02 = dxy * dys - dxs * dyy
    c11 = dxx * dss - dxs * dxs
    c12 = dxy * dxs - dxx * dys
    c22 = dxx * dyy - dxy * dxy
    det3 = dxx * c00 + dxy * c01 + dxs * c02
    safe = torch.where(torch.abs(det3) > 1e-12, det3, torch.ones_like(det3))
    ox = -(c00 * dx + c01 * dy + c02 * ds) / safe
    oy = -(c01 * dx + c11 * dy + c12 * ds) / safe
    os_ = -(c02 * dx + c12 * dy + c22 * ds) / safe
    ox = torch.clamp(ox, -0.6, 0.6)
    oy = torch.clamp(oy, -0.6, 0.6)
    os_ = torch.clamp(os_, -0.6, 0.6)

    refined = D + 0.5 * (dx * ox + dy * oy + ds * os_)
    keep = extremum & edge_ok & (torch.abs(refined) > contrast_th)
    score = torch.where(keep, torch.abs(refined), torch.zeros_like(refined))
    return score, ox, oy, os_


def det_hessian_map(img, taps_sigma, sigma: float = 2.0):
    """Scale-normalized determinant-of-Hessian blob response (SURF's
    detection criterion, Bay 2006): second derivatives of the Gaussian-
    smoothed image as stencils, |Lxy| weighted by 0.912, scaled by
    sigma^4. taps_sigma: ``taps(sigma)`` on the image's device."""
    g = pyramid.gaussian_blur(img, taps_sigma)
    lxx = _roll_edge(g, 0, -1) + _roll_edge(g, 0, 1) - 2.0 * g
    lyy = _roll_edge(g, -1, 0) + _roll_edge(g, 1, 0) - 2.0 * g
    lxy = 0.25 * (
        _roll_edge(g, -1, -1) + _roll_edge(g, 1, 1)
        - _roll_edge(g, -1, 1) - _roll_edge(g, 1, -1)
    )
    w = 0.912 * lxy
    return (sigma ** 4) * (lxx * lyy - w * w)

