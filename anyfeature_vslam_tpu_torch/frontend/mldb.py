"""M-LDB descriptor and main orientation of the AKAZE family, akaze61 (port
of anyfeature_vslam_tpu/frontend/mldb.py).

Around each keypoint a window of half-width 10 * sigma (level pixels) is
rotated into the keypoint frame and cut into 2x2, 3x3 and 4x4 grids; per
cell the means of L and of Lx, Ly rotated into the keypoint frame are
compared pairwise within each grid: (6 + 36 + 120) * 3 = 486 bits, padded
to 488. The main orientation is AKAZE's (from SURF): gradient samples on a
disc of radius 6 * sigma with Gaussian(2.5 sigma) weights, 42 angle bins,
the largest accumulated vector over a pi/3 window.

The numpy builders (``_cell_matrix``, ``_orientation_matrix``,
``_pair_matrices``) are copied from the JAX package; a CPU test holds them
equal. As there, one patch per keypoint and channel is gathered, "rotate
the grid, average each cell" is one constant (P*P, N_ROT * 29) product,
and the keypoint's rotation step is picked after it. Precision as in the
JAX package: those products on operands rounded to bf16, multiplied in
fp32 (see ringdesc.py). The pair comparisons select single cells, so they
are index gathers here (exact, as JAX's 0/1 products are).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .orientation import gather_patches
from .ringdesc import bf16_round, rotation_step

GRIDS = (2, 3, 4)
N_CELLS = sum(d * d for d in GRIDS)          # 29
N_PAIRS = sum(d * d * (d * d - 1) // 2 for d in GRIDS)  # 162
N_BITS = 3 * N_PAIRS                          # 486
N_BITS_PADDED = 488                           # 61 bytes
PATTERN_SIZE = 10.0                           # libAKAZE pattern_size
N_ROT = 16                                    # 22.5 deg rotation quantization

# orientation: disc lattice |i|,|j| <= 6, i^2+j^2 < 36, step = sigma
_ORI_IJ = np.array(
    [(i, j) for i in range(-6, 7) for j in range(-6, 7) if i * i + j * j < 36],
    np.float32,
)  # (109, 2) (x, y) lattice units
N_ORI_BINS = 42                               # ~0.15 rad slide steps
ORI_WINDOW = 7                                # ceil((pi/3) / (2pi/42)) = 7 bins


def patch_radius(sigma_rel: float) -> int:
    """Per-level patch half-size: covers the rotated M-LDB window
    (10*sigma*sqrt(2)) and the orientation disc (6*sigma + stamp)."""
    return int(math.ceil(PATTERN_SIZE * sigma_rel * math.sqrt(2.0))) + 2


def _bilinear_stamp(m, px, py, cols, w, P):
    """Accumulate bilinear weights w at float patch coords (px, py) into
    matrix m[:, cols] (numpy, build time)."""
    x = np.clip(px + (P - 1) / 2.0, 0.0, P - 1.001)
    y = np.clip(py + (P - 1) / 2.0, 0.0, P - 1.001)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = x - x0
    fy = y - y0
    for dy, dx, ww in (
        (0, 0, (1 - fx) * (1 - fy)),
        (0, 1, fx * (1 - fy)),
        (1, 0, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        np.add.at(m, ((y0 + dy) * P + (x0 + dx), cols), w * ww)


_CELL_CACHE: dict = {}


def _cell_matrix(sigma_rel: float, radius: int):
    """(P*P, N_ROT * 29) constant: column (r * 29 + c) is the mean over
    cell c's sample lattice rotated by angle r * 2pi / N_ROT."""
    key = (round(sigma_rel, 4), radius)
    got = _CELL_CACHE.get(key)
    if got is not None:
        return got
    P = 2 * radius + 1
    half = PATTERN_SIZE * sigma_rel  # window half-width, pixels
    m = np.zeros((P * P, N_ROT * N_CELLS), np.float32)
    # per-grid sample density: ~16x16 stamps across the full window
    ns_of = {2: 8, 3: 6, 4: 4}
    for r in range(N_ROT):
        th = 2.0 * math.pi * r / N_ROT
        ca, sa = math.cos(th), math.sin(th)
        cell0 = 0
        for d in GRIDS:
            ns = ns_of[d]
            cw = 2.0 * half / d  # cell width
            for cy in range(d):
                for cx in range(d):
                    # sample lattice inside cell (cx, cy), window coords
                    u = -half + (cx + (np.arange(ns) + 0.5) / ns) * cw
                    v = -half + (cy + (np.arange(ns) + 0.5) / ns) * cw
                    uu, vv = np.meshgrid(u, v)
                    uu = uu.reshape(-1).astype(np.float32)
                    vv = vv.reshape(-1).astype(np.float32)
                    px = uu * ca - vv * sa
                    py = uu * sa + vv * ca
                    col = r * N_CELLS + cell0 + cy * d + cx
                    w = np.full(uu.shape, 1.0 / (ns * ns), np.float32)
                    _bilinear_stamp(m, px, py, np.full_like(uu, col, np.int64).astype(np.int64), w, P)
            cell0 += d * d
    _CELL_CACHE[key] = m
    return m


_ORI_CACHE: dict = {}


def _orientation_matrix(sigma_rel: float, radius: int):
    """(P*P, K) constant: column k bilinearly samples the patch at disc
    lattice point k (scaled by sigma), pre-multiplied by the Gaussian
    weight exp(-r^2 / (2 * 2.5^2)) in lattice units (libAKAZE gauss25)."""
    key = (round(sigma_rel, 4), radius)
    got = _ORI_CACHE.get(key)
    if got is not None:
        return got
    P = 2 * radius + 1
    K = _ORI_IJ.shape[0]
    m = np.zeros((P * P, K), np.float32)
    g = np.exp(-(_ORI_IJ[:, 0] ** 2 + _ORI_IJ[:, 1] ** 2) / (2.0 * 2.5 * 2.5))
    px = _ORI_IJ[:, 0] * sigma_rel
    py = _ORI_IJ[:, 1] * sigma_rel
    _bilinear_stamp(m, px, py, np.arange(K, dtype=np.int64), g.astype(np.float32), P)
    _ORI_CACHE[key] = m
    return m


_PAIR_CACHE: dict = {}


def _pair_matrices():
    """Two (29, 162) 0/1 selectors: bits = cell_means @ A  >  cell_means @ B
    where columns enumerate within-grid pairs (i < j) grid-major."""
    got = _PAIR_CACHE.get("p")
    if got is not None:
        return got
    a = np.zeros((N_CELLS, N_PAIRS), np.float32)
    b = np.zeros((N_CELLS, N_PAIRS), np.float32)
    col = 0
    cell0 = 0
    for d in GRIDS:
        n = d * d
        for i in range(n):
            for j in range(i + 1, n):
                a[cell0 + i, col] = 1.0
                b[cell0 + j, col] = 1.0
                col += 1
        cell0 += n
    _PAIR_CACHE["p"] = (a, b)
    return a, b


def pair_indices():
    """The cells the pair selectors pick, (2, 162) int64: bit c compares
    cell [0, c] with cell [1, c]."""
    a, b = _pair_matrices()
    return torch.from_numpy(np.stack([a.argmax(0), b.argmax(0)]).astype(np.int64))


def tensors(sigma_rel: float):
    """(orientation matrix, cell matrix), both rounded to bf16, as fp32 CPU
    tensors for one level scale (the extractor keeps them as buffers)."""
    radius = patch_radius(sigma_rel)
    return (bf16_round(torch.from_numpy(_orientation_matrix(sigma_rel, radius).copy())),
            bf16_round(torch.from_numpy(_cell_matrix(sigma_rel, radius).copy())))


def main_orientation(lx_flat, ly_flat, ori_m):
    """AKAZE/SURF sliding-window dominant orientation, (N,) radians in
    [-pi, pi], from flat gradient patches (N, P*P) and the level's
    orientation matrix (``tensors``)."""
    sx = bf16_round(lx_flat) @ ori_m  # (N, K) weighted samples
    sy = bf16_round(ly_flat) @ ori_m
    ang = torch.atan2(sy, sx)
    b = torch.floor((ang + math.pi) * (N_ORI_BINS / (2.0 * math.pi))).to(torch.int64)
    b = torch.clamp(b, 0, N_ORI_BINS - 1)
    # per-bin sums as a one-hot product: a fixed order on every device
    onehot = torch.nn.functional.one_hot(b, N_ORI_BINS).to(sx.dtype)  # (N, K, B)
    bx = (sx[:, None, :] @ onehot)[:, 0]
    by = (sy[:, None, :] @ onehot)[:, 0]
    # circular pi/3 windowed sums over bins
    bx2 = torch.cat([bx, bx[:, :ORI_WINDOW - 1]], 1)
    by2 = torch.cat([by, by[:, :ORI_WINDOW - 1]], 1)
    wx = bx2[:, :N_ORI_BINS]
    wy = by2[:, :N_ORI_BINS]
    for k in range(1, ORI_WINDOW):
        wx = wx + bx2[:, k:k + N_ORI_BINS]
        wy = wy + by2[:, k:k + N_ORI_BINS]
    best = torch.argmax(wx * wx + wy * wy, dim=1, keepdim=True)  # the first
    return torch.atan2(torch.gather(wy, 1, best)[:, 0], torch.gather(wx, 1, best)[:, 0])


def describe_mldb(L, Lx, Ly, xy, valid, sigma_rel: float, ori_m, cell_m, pairs):
    """M-LDB descriptors for one evolution level.

    L, Lx, Ly: (h, w) level channels; xy: (N, 2) keypoints in level
    pixels; valid: (N,) bool; ori_m, cell_m: ``tensors(sigma_rel)`` and
    pairs: ``pair_indices()``, on the level's device. Returns angle (N,)
    float32 and bits (N, 488) uint8 in {0, 1} (486 M-LDB bits and 2 zero
    pads), zero on invalid rows.
    """
    radius = patch_radius(sigma_rel)
    n = xy.shape[0]
    pl, px, py = (gather_patches(c, xy, radius).reshape(n, -1) for c in (L, Lx, Ly))
    angle = main_orientation(px, py, ori_m)

    step = rotation_step(angle, N_ROT)
    pick = step[:, None, None].expand(n, 1, N_CELLS)

    def cell_means(flat):
        m = (bf16_round(flat) @ cell_m).view(n, N_ROT, N_CELLS)
        return torch.gather(m, 1, pick)[:, 0]

    cL, cX, cY = cell_means(pl), cell_means(px), cell_means(py)
    # rotate gradient means into the keypoint frame (quantized angle)
    th = step.to(torch.float32) * (2.0 * math.pi / N_ROT)
    ca, sa = torch.cos(th)[:, None], torch.sin(th)[:, None]
    dX = ca * cX + sa * cY
    dY = -sa * cX + ca * cY
    bits = torch.cat([(ch[:, pairs[0]] - ch[:, pairs[1]] > 0) for ch in (cL, dX, dY)], 1)
    bits = torch.nn.functional.pad(bits.to(torch.uint8), (0, N_BITS_PADDED - N_BITS))
    return angle, torch.where(valid[:, None], bits, torch.zeros_like(bits))
