"""Gradient-histogram float descriptors (port of
anyfeature_vslam_tpu/frontend/graddesc.py): sift128 (4x4 cells x 8
orientation bins), surf64 (4x4 cells x [sum dx, sum |dx|, sum dy,
sum |dy|]) and grad48 (4x4 cells x [sum |dx|, sum |dy|, sum mag]), each
L2-normalised, clamped at 0.25 and normalised again.

Central-difference gradient maps of the level (a wrapped roll whose
borders are then zeroed), a 31x31 patch of each per keypoint, and one
constant (961, N_ROT * 400) bilinear matrix that samples a 20x20 grid at
one-pixel spacing rotated to each of ``N_ROT`` steps (column r * 400 + s:
grid point s at step r); the keypoint's step is picked by index, the
sampled gradients are rotated into the keypoint frame by that step's
angle, and the cell sums are a product with a constant one-hot
(400, 16) sample -> cell matrix. ``describe_grad_auto`` takes the angle
from the patches themselves: SIFT's 36-bin gradient histogram over a
Gaussian window, smoothed twice, peak plus parabolic interpolation.

Precision as in the JAX package: the sampling product on operands
rounded to bf16, multiplied in fp32 (see ringdesc.py); the histograms
and cell sums in fp32 products with one-hot matrices (no atomics, so the
card and the CPU sum in the same order). The numpy constants are copied
from the JAX package; a CPU test holds them equal. learned48 shares the
sampling matrix.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .orientation import gather_patches
from .ringdesc import bf16_round, rotation_step

PATCH = 20          # samples per side (covering a 20x20 rotated window)
CELLS = 4           # 4x4 spatial cells
_SPACING = 1.0      # sample spacing in pixels at the keypoint's level
N_ROT = 16          # rotation quantization steps (22.5 deg)
PATCH_RADIUS = 15   # gathered patch half-size
_P = 2 * PATCH_RADIUS + 1
_N_SAMP = PATCH * PATCH
N_ORI_BINS = 36
# components per cell by descriptor width
N_COMP = {128: 8, 64: 4, 48: 3}


def _grid():
    half = (PATCH - 1) / 2.0
    ys, xs = np.mgrid[0:PATCH, 0:PATCH].astype(np.float32)
    return (xs - half) * _SPACING, (ys - half) * _SPACING


_CELL_OF = np.clip(
    (np.mgrid[0:PATCH, 0:PATCH][0] * CELLS // PATCH), 0, CELLS - 1
)  # row cell index per sample row


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


def _cell_matrix():
    """(400, 16) one-hot sample -> spatial-cell assignment."""
    cell_row = _CELL_OF.reshape(-1)
    cell_col = _CELL_OF.T.reshape(-1)
    cell_id = cell_row * CELLS + cell_col
    m = np.zeros((_N_SAMP, CELLS * CELLS), np.float32)
    m[np.arange(_N_SAMP), cell_id] = 1.0
    return m


def _ori_weight_np():
    """Gaussian window over the gathered patch for orientation voting
    (sigma = half the patch radius, Lowe's 1.5x-scale window)."""
    half = PATCH_RADIUS
    ys, xs = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float32)
    s = PATCH_RADIUS / 2.0
    return np.exp(-(xs * xs + ys * ys) / (2.0 * s * s)).reshape(-1)


def _rotation_table_np():
    """(N_ROT, 2) float32 [cos, sin] of each step's float32 angle,
    correctly rounded (what jnp.cos / jnp.sin give on the CPU; torch.sin
    is an ulp off for some steps, and the card's may differ again)."""
    th = np.arange(N_ROT, dtype=np.float32) * np.float32(2.0 * math.pi / N_ROT)
    return np.array([[math.cos(float(t)), math.sin(float(t))] for t in th], np.float32)


def sample_tensor():
    """The sampling matrix rounded to bf16, as an fp32 CPU tensor (the
    extractors keep it as a buffer)."""
    return bf16_round(torch.from_numpy(_sample_matrix().copy()))


def tensors():
    """(sampling matrix rounded to bf16, cell matrix, rotation table,
    orientation window) as fp32 CPU tensors: ``describe_grad_auto``'s
    arguments after ``dim`` (``describe_grad`` takes the first three)."""
    return (sample_tensor(), torch.from_numpy(_cell_matrix()),
            torch.from_numpy(_rotation_table_np()), torch.from_numpy(_ori_weight_np()))


def _gradient_maps(img):
    """Central-difference gradients; the wrapped borders are zeroed."""
    gx = 0.5 * (torch.roll(img, -1, 1) - torch.roll(img, 1, 1))
    gy = 0.5 * (torch.roll(img, -1, 0) - torch.roll(img, 1, 0))
    gx[:, 0] = 0.0
    gx[:, -1] = 0.0
    gy[0, :] = 0.0
    gy[-1, :] = 0.0
    return gx, gy


def _fma(a, b, c):
    """a * b + c rounded once to float32, on any device: the product of
    two float32 values is exact in float64, and the float64 sum rounds to
    the float32 result of a fused multiply-add (barring a double rounding,
    about once in 2^29)."""
    return (a.double() * b.double() + c.double()).float()


def _atan2(y, x):
    """float32 atan2 through float64: the same on the card and the CPU
    (their float32 atan2 differ by an ulp, and a bin edge lies on every
    axis and diagonal, where rendered gradients often point)."""
    return torch.atan2(y.double(), x.double()).float()


def _onehot_sum(values, bins, n_bins: int):
    """(N, n_bins) sums of values (N, S) by bin (N, S), as a product with
    the one-hot bins (fp32, no atomics)."""
    onehot = torch.nn.functional.one_hot(bins, n_bins).to(values.dtype)  # (N, S, B)
    return (values[:, None, :] @ onehot)[:, 0]


def dominant_angle_from_patches(pgx, pgy, ori_w):
    """SIFT dominant orientation (N,) in radians from flat gradient patches
    (N, 961): a 36-bin magnitude histogram over the Gaussian window ori_w,
    the circular [1, 4, 6, 4, 1] / 16 smoothing twice, the first peak and
    a parabolic interpolation (Lowe 2004 sec. 5)."""
    mag = torch.sqrt(pgx * pgx + pgy * pgy + 1e-12) * ori_w
    ori = _atan2(pgy, pgx)  # [-pi, pi]
    binf = (ori + math.pi) * (N_ORI_BINS / (2.0 * math.pi))
    b0 = torch.clamp(binf.to(torch.int64) % N_ORI_BINS, 0, N_ORI_BINS - 1)
    hist = _onehot_sum(mag, b0, N_ORI_BINS)
    for _ in range(2):
        hist = (
            6.0 * hist
            + 4.0 * (torch.roll(hist, 1, 1) + torch.roll(hist, -1, 1))
            + (torch.roll(hist, 2, 1) + torch.roll(hist, -2, 1))
        ) * (1.0 / 16.0)
    peak = torch.argmax(hist, dim=1, keepdim=True)  # the first
    hp = torch.gather(hist, 1, peak)[:, 0]
    hl = torch.gather(hist, 1, (peak - 1) % N_ORI_BINS)[:, 0]
    hr = torch.gather(hist, 1, (peak + 1) % N_ORI_BINS)[:, 0]
    denom = hl - 2.0 * hp + hr
    frac = torch.where(torch.abs(denom) > 1e-6, 0.5 * (hl - hr) / denom,
                       torch.zeros_like(denom))
    binc = peak[:, 0].to(torch.float32) + torch.clamp(frac, -0.5, 0.5) + 0.5
    return (binc * (2.0 * math.pi / N_ORI_BINS)) - math.pi


def _patches(img, xy):
    n = xy.shape[0]
    gx_map, gy_map = _gradient_maps(img)
    return (gather_patches(gx_map, xy, PATCH_RADIUS).reshape(n, _P * _P),
            gather_patches(gy_map, xy, PATCH_RADIUS).reshape(n, _P * _P))


def describe_grad_auto(img, xy, valid, dim, sample_mat, cell_mat, rot_cs, ori_w):
    """``describe_grad`` with the keypoint angle taken as the dominant
    gradient orientation of the same patches. Returns (angle (N,), desc
    (N, dim))."""
    pgx, pgy = _patches(img, xy)
    angle = dominant_angle_from_patches(pgx, pgy, ori_w)
    return angle, describe_from_patches(pgx, pgy, angle, valid, dim, sample_mat, cell_mat,
                                        rot_cs)


def describe_grad(img, xy, angle, valid, dim, sample_mat, cell_mat, rot_cs):
    """Float descriptors (N, dim), unit L2 norm, zero on invalid rows, of
    keypoints xy (N, 2) with orientations angle (N,) on a level image.
    dim in {48, 64, 128}; sample_mat, cell_mat, rot_cs: the first three
    of ``tensors()``, on the image's device."""
    pgx, pgy = _patches(img, xy)
    return describe_from_patches(pgx, pgy, angle, valid, dim, sample_mat, cell_mat, rot_cs)


def describe_from_patches(pgx, pgy, angle, valid, dim, sample_mat, cell_mat, rot_cs):
    """``describe_grad`` from pre-gathered flat gradient patches (N, 961)."""
    n_comp = N_COMP[dim]
    n = pgx.shape[0]
    sgx = (bf16_round(pgx) @ sample_mat).view(n, N_ROT, _N_SAMP)
    sgy = (bf16_round(pgy) @ sample_mat).view(n, N_ROT, _N_SAMP)
    step = rotation_step(angle, N_ROT)
    pick = step[:, None, None].expand(n, 1, _N_SAMP)
    sgx = torch.gather(sgx, 1, pick)[:, 0]
    sgy = torch.gather(sgy, 1, pick)[:, 0]

    # rotate the sampled gradients into the keypoint frame (quantized
    # angle), each as the fused multiply-add the JAX package's CPU program
    # computes: the 8-bin histogram cuts at the axes, where a gradient's
    # last bit picks the bin
    cs = rot_cs[step]
    ca, sa = cs[:, 0:1], cs[:, 1:2]
    dx = _fma(ca, sgx, sa * sgy)     # gradient along the keypoint's x-axis
    dy = _fma(ca, sgy, -sa * sgx)    # gradient along the keypoint's y-axis

    if n_comp == 8:
        # SIFT: 8-bin orientation histogram weighted by magnitude
        mag = torch.sqrt(dx * dx + dy * dy + 1e-12)
        ori = _atan2(dy, dx)
        binf = (ori + math.pi) * (8 / (2 * math.pi))
        b0 = torch.clamp(binf.to(torch.int64) % 8, 0, 7)
        comps = torch.nn.functional.one_hot(b0, 8).to(mag.dtype) * mag[..., None]
    elif n_comp == 4:
        # SURF: per cell [sum dx, sum |dx|, sum dy, sum |dy|]
        comps = torch.stack([dx, torch.abs(dx), dy, torch.abs(dy)], -1)
    else:
        # three components: [sum |dx|, sum |dy|, sum mag]
        mag = torch.sqrt(dx * dx + dy * dy + 1e-12)
        comps = torch.stack([torch.abs(dx), torch.abs(dy), mag], -1)
    # (N, K, 400) @ (400, 16) -> per cell and component, cell-major
    desc = (comps.transpose(1, 2) @ cell_mat).transpose(1, 2).reshape(n, -1)

    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(norm, min=1e-8)
    # SIFT-style clamp + renormalize (illumination robustness)
    desc = torch.clamp(desc, max=0.25)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(norm, min=1e-8)
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))
