"""M-SURF 64-d descriptor of the KAZE family, kaze64 (port of
anyfeature_vslam_tpu/frontend/msurf.py).

A 20s x 20s window along the keypoint angle, 4x4 subregions, per
subregion Gaussian-weighted sums of the rotated gradient responses
[sum dx, sum |dx|, sum dy, sum |dy|] -> 64 dims, L2-normalised. As in the
JAX package, the gradients are sampled on a fixed axis-aligned 26x26
lattice (one constant bilinear (P*P, 676) matrix per sample spacing),
rotated into the keypoint frame with the continuous angle, and only the
subregion weights are rotation-quantized ((N_ROT, 676, 16) constants,
the keypoint's step picked by index).

The numpy builders (``_lattice_coords``, ``_sample_matrix``,
``_cell_weights``) are copied from the JAX package; a CPU test holds them
equal. Precision as in the JAX package: the products on operands rounded
to bf16, multiplied in fp32 (see ringdesc.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import mldb
from .orientation import gather_patches
from .ringdesc import bf16_round, rotation_step

CELLS = 4                   # 4x4 subregions
HALF_CELLS = CELLS / 2.0
CELL_SIZE = 5.0             # subregion width in spacing units (20/4)
LATTICE = 26                # 26x26 axis-aligned sample lattice (extent
                            # +/-12.5 spacing units; the rotated window's
                            # far corners beyond that carry Gaussian weight
                            # < 0.1 and are dropped)
_N_SAMP = LATTICE * LATTICE
N_ROT = 16                  # cell-assignment rotation quantization
WEIGHT_SIGMA = 3.3          # per-cell Gaussian, spacing units (SURF ~3.3s)


def patch_radius(spacing: float) -> int:
    """Patch half-size covering the lattice extent."""
    half = (LATTICE - 1) / 2.0 * spacing
    return int(math.ceil(half)) + 2


def _lattice_coords():
    half = (LATTICE - 1) / 2.0
    ys, xs = np.mgrid[0:LATTICE, 0:LATTICE].astype(np.float32)
    return xs - half, ys - half   # spacing units


_LX, _LY = _lattice_coords()

_SAMPLE_CACHE: dict = {}


def _sample_matrix(spacing: float, radius: int):
    """(P*P, LATTICE^2) bilinear sampling matrix at `spacing` px/step."""
    key = (round(spacing, 4), radius)
    got = _SAMPLE_CACHE.get(key)
    if got is not None:
        return got
    P = 2 * radius + 1
    gx = (_LX * spacing).reshape(-1)
    gy = (_LY * spacing).reshape(-1)
    x = np.clip(gx + radius, 0.0, P - 1.001)
    y = np.clip(gy + radius, 0.0, P - 1.001)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = x - x0
    fy = y - y0
    m = np.zeros((P * P, _N_SAMP), np.float32)
    cols = np.arange(_N_SAMP)
    for dy, dx, w in (
        (0, 0, (1 - fx) * (1 - fy)),
        (0, 1, fx * (1 - fy)),
        (1, 0, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        np.add.at(m, ((y0 + dy) * P + (x0 + dx), cols), w)
    _SAMPLE_CACHE[key] = m
    return m


_CELLW = None


def _cell_weights():
    """(N_ROT, LATTICE^2, 16) Gaussian soft assignment of each lattice
    point (rotated into the keypoint frame) to the 4x4 subregion centers
    at (-7.5, -2.5, 2.5, 7.5) spacing units."""
    global _CELLW
    if _CELLW is not None:
        return _CELLW
    centers = (np.arange(CELLS, dtype=np.float32) - (CELLS - 1) / 2.0) * CELL_SIZE
    out = np.zeros((N_ROT, _N_SAMP, CELLS * CELLS), np.float32)
    gx = _LX.reshape(-1)
    gy = _LY.reshape(-1)
    inv2s2 = 1.0 / (2.0 * WEIGHT_SIGMA * WEIGHT_SIGMA)
    for r in range(N_ROT):
        th = 2.0 * math.pi * r / N_ROT
        ca, sa = math.cos(th), math.sin(th)
        # inverse-rotate lattice points into the keypoint frame
        u = gx * ca + gy * sa
        v = -gx * sa + gy * ca
        for cy in range(CELLS):
            for cx in range(CELLS):
                du = u - centers[cx]
                dv = v - centers[cy]
                w = np.exp(-(du * du + dv * dv) * inv2s2)
                # hard cutoff: a sample only feeds cells it falls within
                # (half-cell overlap, as M-SURF's overlapping subregions)
                w = np.where(
                    (np.abs(du) < CELL_SIZE) & (np.abs(dv) < CELL_SIZE), w, 0.0
                )
                out[r, :, cy * CELLS + cx] = w
    _CELLW = out
    return out


def tensors(spacing: float):
    """(orientation matrix, sampling matrix) for one sample spacing,
    rounded to bf16, as fp32 CPU tensors (the extractor keeps them as
    buffers)."""
    radius = patch_radius(spacing)
    return (bf16_round(torch.from_numpy(mldb._orientation_matrix(spacing, radius).copy())),
            bf16_round(torch.from_numpy(_sample_matrix(spacing, radius).copy())))


def cell_weight_tensor():
    """``_cell_weights()`` rounded to bf16, as an fp32 CPU tensor."""
    return bf16_round(torch.from_numpy(_cell_weights().copy()))


def describe_msurf(gx_map, gy_map, xy, angle, valid, spacing: float, sample_m, cell_w):
    """M-SURF descriptors (N, 64), unit L2 norm, from gradient maps at
    keypoints xy (N, 2) with orientations angle (N,)."""
    radius = patch_radius(spacing)
    n = xy.shape[0]
    pgx = gather_patches(gx_map, xy, radius).reshape(n, -1)
    pgy = gather_patches(gy_map, xy, radius).reshape(n, -1)
    return describe_from_flat(pgx, pgy, angle, valid, sample_m, cell_w)


def describe_kaze(gx_map, gy_map, xy, valid, spacing: float, ori_m, sample_m, cell_w):
    """KAZE: one patch gather shared between the SURF sliding-window main
    orientation (mldb.main_orientation) and the M-SURF descriptor.
    (ori_m, sample_m): ``tensors(spacing)`` and cell_w:
    ``cell_weight_tensor()``, on the maps' device.
    Returns (angle (N,), desc (N, 64))."""
    radius = patch_radius(spacing)
    n = xy.shape[0]
    pgx = gather_patches(gx_map, xy, radius).reshape(n, -1)
    pgy = gather_patches(gy_map, xy, radius).reshape(n, -1)
    angle = mldb.main_orientation(pgx, pgy, ori_m)
    return angle, describe_from_flat(pgx, pgy, angle, valid, sample_m, cell_w)


def describe_from_flat(pgx, pgy, angle, valid, sample_m, cell_w):
    """M-SURF from pre-gathered flat gradient patches (N, P*P); zero on
    invalid rows."""
    n = pgx.shape[0]
    sgx = bf16_round(pgx) @ sample_m  # (N, 676)
    sgy = bf16_round(pgy) @ sample_m
    # rotate gradient vectors into the keypoint frame (continuous angle)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    dx = ca * sgx + sa * sgy
    dy = -sa * sgx + ca * sgy
    w_sel = cell_w[rotation_step(angle, N_ROT)]  # (N, 676, 16)
    comps = bf16_round(torch.stack([dx, torch.abs(dx), dy, torch.abs(dy)], -1))  # (N, 676, 4)
    desc = (w_sel.transpose(1, 2) @ comps).reshape(n, CELLS * CELLS * 4)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(norm, min=1e-8)
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))
