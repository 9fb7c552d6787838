"""Steered BRIEF-256 descriptors (port of anyfeature_vslam_tpu/frontend/brief.py).

The pair pattern is drawn once from a fixed-seed isotropic Gaussian with
numpy, exactly as in the JAX package, and quantised to ``N_ROT`` rotation
steps. The JAX package evaluates every (step, bit) as one
``bf16(patch) @ {-1, 0, +1}`` product with an fp32 accumulator, so each bit
is exactly ``bf16(I(p2)) - bf16(I(p1)) > 0`` (0 where p1 and p2 round to
the same pixel). Here the same bit is a gather and compare: the sampling
matrix is reduced to two (N_ROT, n_bits) index tables, p1 = the row of its
-1, p2 = the row of its +1 (both 0 for an all-zero column, which then
compares a pixel with itself and gives 0, as the product does).
"""

from __future__ import annotations

import numpy as np
import torch

N_BITS = 256
N_ROT = 30                     # rotation quantization steps (12 deg, as rBRIEF)
PATCH_RADIUS = 15
_P = 2 * PATCH_RADIUS + 1      # 31
PATTERN_RADIUS = 13.0          # pattern norm clip: rotations stay in-patch
PATCH_SIGMA = 31.0 / 5.0       # classic BRIEF Gaussian spread


def make_pattern(n_bits: int = N_BITS, seed: int = 20240607):
    """(n_bits, 2, 2) float32 point pairs [(x, y) of p1, p2]."""
    rng = np.random.default_rng(seed + n_bits)
    pts = rng.normal(0.0, PATCH_SIGMA, size=(n_bits, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, PATTERN_RADIUS / np.maximum(norm, 1e-9))
    return (pts * scale).astype(np.float32)


def rotation_matrix_np(n_bits: int = N_BITS):
    """(961, N_ROT * n_bits) {-1, 0, +1} float32 sampling matrix: column
    r * n_bits + k computes I(p2_k) - I(p1_k) with both points rotated by
    r * 2pi / N_ROT and rounded to the patch grid."""
    pat = make_pattern(n_bits)
    m = np.zeros((_P * _P, N_ROT * n_bits), np.float32)
    for r in range(N_ROT):
        th = 2.0 * np.pi * r / N_ROT
        ca, sa = np.cos(th), np.sin(th)
        rx = np.round(pat[..., 0] * ca - pat[..., 1] * sa).astype(np.int64)
        ry = np.round(pat[..., 0] * sa + pat[..., 1] * ca).astype(np.int64)
        flat = (ry + PATCH_RADIUS) * _P + (rx + PATCH_RADIUS)
        cols = r * n_bits + np.arange(n_bits)
        np.subtract.at(m, (flat[:, 0], cols), 1.0)
        np.add.at(m, (flat[:, 1], cols), 1.0)
    return m


def sample_index_tables_np(n_bits: int = N_BITS):
    """(p1, p2): (N_ROT, n_bits) int64 flat patch indices read by each
    (rotation step, bit), derived from the sampling matrix."""
    m = rotation_matrix_np(n_bits)
    p1 = np.argmin(m, axis=0).reshape(N_ROT, n_bits)
    p2 = np.argmax(m, axis=0).reshape(N_ROT, n_bits)
    return p1.astype(np.int64), p2.astype(np.int64)


def rotation_step(angle):
    """Nearest of the N_ROT rotation steps for angles in radians."""
    return torch.round(angle * (N_ROT / (2.0 * np.pi))).to(torch.int64) % N_ROT


def describe_from_flat(flat, angle, valid, p1, p2):
    """Descriptor bits (N, n_bits) uint8 {0, 1} from flat blurred patches
    (N, 961), orientations (N,) and the index tables of
    ``sample_index_tables_np`` (on flat's device). Invalid rows are 0."""
    step = rotation_step(angle)
    q = flat.to(torch.bfloat16)
    i1 = torch.gather(q, 1, p1[step])
    i2 = torch.gather(q, 1, p2[step])
    bits = (i2.to(torch.float32) - i1.to(torch.float32)) > 0
    return (bits & valid[:, None]).to(torch.uint8)


def unpack_bits(desc_packed):
    """(N, n_bits / 8) uint8 -> (N, n_bits) uint8 bits, least significant
    first: the inverse of the descriptors' packing."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_packed.device)
    bits = (desc_packed[..., None] >> shifts) & 1
    return bits.reshape(desc_packed.shape[0], -1)
