"""Concentric-ring binary descriptors: BRISK (brisk48, 384 bits) and FREAK
(anyfeat_bin, 512 bits). Port of anyfeature_vslam_tpu/frontend/ringdesc.py.

The patterns and the constant matrices are numpy, copied from the JAX
package (a CPU test holds them equal): "smooth at sample point p with
sigma_p, rotated by step r" is a Gaussian-stamp column, so the bits of
every rotation step come from one (N, P^2) x (P^2, N_ROT * n_bits)
product and a per-keypoint pick of its step, and the ring orientation is
one more (N, P^2) x (P^2, 2) product in the unrotated frame.

Precision as in the JAX package: the orientation product in full fp32;
the descriptor product on operands rounded to bf16. JAX multiplies the
bf16 operands with an fp32 accumulator; in torch a bf16 product returns
bf16 and would round the sums a second time, flipping bits near 0. So the
operands are rounded to bf16 and multiplied back in fp32 (TF32 off, the
package's ``__init__``): the products of bf16 values are exact in fp32,
and only the summation order differs from JAX.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .orientation import gather_patches

N_ROT = 16
PATCH_RADIUS = {"brisk": 16, "freak": 22}  # cover ring extent + 3-sigma stamps
N_BITS = {"brisk": 384, "freak": 512}

# ---------------------------------------------------------------- patterns


def brisk_pattern():
    """BRISK sampling geometry at pattern scale 1 (~ level pixels).

    Returns (points (60,2) float32, sigmas (60,), short_pairs (384,2) int,
    long_pairs (L,2) int)."""
    radii = (0.0, 2.9, 4.9, 7.4, 10.8)
    counts = (1, 10, 14, 15, 20)
    pts, sigmas = [], []
    for r, n in zip(radii, counts):
        for k in range(n):
            th = 2.0 * math.pi * k / n + (0.5 * math.pi / n if r > 0 else 0.0)
            pts.append((r * math.cos(th), r * math.sin(th)))
            # sigma proportional to in-ring point spacing (paper Sec 4.2)
            sigmas.append(max(0.55, 0.85 * r * math.sin(math.pi / n)) if r > 0 else 0.55)
    pts = np.asarray(pts, np.float32)
    sigmas = np.asarray(sigmas, np.float32)

    n = len(pts)
    ii, jj = np.triu_indices(n, k=1)
    d = np.linalg.norm(pts[ii] - pts[jj], axis=1)
    order = np.argsort(d, kind="stable")
    short = np.stack([ii[order[:384]], jj[order[:384]]], axis=1)
    long_mask = d > 13.67
    long_pairs = np.stack([ii[long_mask], jj[long_mask]], axis=1)
    return pts, sigmas, short.astype(np.int64), long_pairs.astype(np.int64)


def freak_pattern():
    """FREAK retinal geometry: 1 fovea + 7 rings x 6 fields.

    Returns (points (43,2), sigmas (43,), pairs (512,2), ori_pairs (45,2)).
    """
    n_rings = 7
    pts = [(0.0, 0.0)]
    sigmas = [0.6]
    for k in range(n_rings):            # k=0 innermost .. 6 outermost
        r = 1.4 * (1.35 ** k) * 1.6     # exponential eccentricity, ~2.2..14
        # overlapping fields growing with eccentricity, capped so the
        # 3-sigma stamp stays inside the patch
        s = max(0.6, min(0.45 * r, 2.5))
        for m in range(6):
            th = 2.0 * math.pi * m / 6 + (math.pi / 6 if k % 2 else 0.0)
            pts.append((r * math.cos(th), r * math.sin(th)))
            sigmas.append(s)
    pts = np.asarray(pts, np.float32)
    sigmas = np.asarray(sigmas, np.float32)

    n = len(pts)                         # 43
    ii, jj = np.triu_indices(n, k=1)     # 903 pairs
    size = sigmas[ii] + sigmas[jj]
    # coarse-to-fine ordering, deterministic subsample to 512
    order = np.argsort(-size, kind="stable")
    keep = order[np.linspace(0, len(order) - 1, 512).round().astype(int)]
    pairs = np.stack([ii[keep], jj[keep]], axis=1)

    # orientation: long-baseline pairs only (opposing fields on the outer
    # rings; short baselines make the gradient estimate unstable)
    dist = np.linalg.norm(pts[ii] - pts[jj], axis=1)
    long_mask = dist > 20.0
    opairs = np.stack([ii[long_mask], jj[long_mask]], axis=1).astype(np.int64)
    return pts, sigmas, pairs, opairs


# ------------------------------------------------------- matrix construction


def _stamp(m, col, px: float, py: float, sigma: float, P: int, sign: float):
    """Accumulate a unit-mass Gaussian stamp centered at patch coords
    (px, py) (origin at patch center) into column `col` of (P*P, C) m."""
    r = max(1, int(math.ceil(3.0 * sigma)))
    c = (P - 1) / 2.0
    x, y = px + c, py + c
    x0, y0 = int(math.floor(x - r)), int(math.floor(y - r))
    xs = np.arange(max(x0, 0), min(x0 + 2 * r + 2, P))
    ys = np.arange(max(y0, 0), min(y0 + 2 * r + 2, P))
    if len(xs) == 0 or len(ys) == 0:
        return
    wx = np.exp(-((xs - x) ** 2) / (2 * sigma * sigma))
    wy = np.exp(-((ys - y) ** 2) / (2 * sigma * sigma))
    w = np.outer(wy, wx)
    w /= max(w.sum(), 1e-12)
    rows = (ys[:, None] * P + xs[None, :]).reshape(-1)
    m[rows, col] += sign * w.reshape(-1)


@functools.cache
def _ring_matrices(kind: str, radius: int):
    """(desc (P*P, N_ROT*n_bits), ori (P*P, 2)) float32 constants, built
    once per process (read-only: callers copy them into tensors)."""
    if kind == "brisk":
        pts, sigmas, pairs, opairs = brisk_pattern()
    else:
        pts, sigmas, pairs, opairs = freak_pattern()
    P = 2 * radius + 1
    n_bits = pairs.shape[0]
    desc = np.zeros((P * P, N_ROT * n_bits), np.float32)
    for r in range(N_ROT):
        th = 2.0 * math.pi * r / N_ROT
        ca, sa = math.cos(th), math.sin(th)
        rx = pts[:, 0] * ca - pts[:, 1] * sa
        ry = pts[:, 0] * sa + pts[:, 1] * ca
        for b, (i, j) in enumerate(pairs):
            col = r * n_bits + b
            # bit = I(p_i) < I(p_j)  ->  stamp(+p_j) + stamp(-p_i) > 0
            _stamp(desc, col, rx[j], ry[j], sigmas[j], P, +1.0)
            _stamp(desc, col, rx[i], ry[i], sigmas[i], P, -1.0)

    # orientation g = sum_pairs (I(p_i) - I(p_j)) (p_i - p_j) / |p_i - p_j|^2
    ori = np.zeros((P * P, 2), np.float32)
    for (i, j) in opairs:
        dvec = pts[i] - pts[j]
        d2 = float(dvec @ dvec)
        if d2 < 1e-9:
            continue
        for col in (0, 1):
            comp = float(dvec[col]) / d2
            _stamp(ori, col, pts[i, 0], pts[i, 1], sigmas[i], P, comp)
            _stamp(ori, col, pts[j, 0], pts[j, 1], sigmas[j], P, -comp)
    desc.flags.writeable = False
    ori.flags.writeable = False
    return desc, ori


def bf16_round(t):
    """fp32 values rounded to the nearest bf16 (ties to even), kept in fp32."""
    return t.to(torch.bfloat16).to(torch.float32)


def ring_tensors(kind: str):
    """The descriptor matrix rounded to bf16 and the orientation matrix,
    as fp32 CPU tensors (``FeatureExtractor`` keeps them as buffers)."""
    desc, ori = _ring_matrices(kind, PATCH_RADIUS[kind])
    return bf16_round(torch.from_numpy(desc.copy())), torch.from_numpy(ori.copy())


def rotation_step(angle, n_rot: int = N_ROT):
    """Nearest of n_rot rotation steps, int64: torch rounds half to even
    and takes a Python-style modulo, as jnp does."""
    return torch.round(angle * (n_rot / (2.0 * math.pi))).to(torch.int64) % n_rot


def describe_ring(img, xy, valid, kind: str, desc_m, ori_m):
    """BRISK / FREAK descriptors from the RAW level image (the per-point
    Gaussian smoothing lives in the stamps). desc_m, ori_m: ``ring_tensors``
    on the image's device. Returns (angle (N,), bits (N, n_bits) uint8,
    zero on invalid rows)."""
    radius = PATCH_RADIUS[kind]
    n_bits = N_BITS[kind]
    n = xy.shape[0]
    flat = gather_patches(img, xy, radius).reshape(n, -1)
    g = flat @ ori_m
    angle = torch.atan2(g[:, 1], g[:, 0])
    diffs = (bf16_round(flat) @ desc_m).view(n, N_ROT, n_bits)
    step = rotation_step(angle)
    picked = torch.gather(diffs, 1, step[:, None, None].expand(n, 1, n_bits))[:, 0]
    bits = ((picked > 0) & valid[:, None]).to(torch.uint8)
    return angle, bits
