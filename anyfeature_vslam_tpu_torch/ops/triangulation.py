"""Batched two-view linear triangulation + acceptance gates (port of
anyfeature_vslam_tpu/ops/triangulation.py).

The reference triangulates one candidate match at a time with an SVD of the
4x4 DLT system and then applies cheirality / parallax / reprojection /
scale-consistency gates (reference src/LocalMapping.cc:231-473 and
src/Initializer.cc Triangulate + CheckRT). Here the whole match set is
triangulated as one batched computation; gates return masks.
"""

from __future__ import annotations

import torch


def _dlt_rows(p1, p2, uv1, uv2):
    p1 = p1.expand(uv1.shape[:-1] + (3, 4))
    p2 = p2.expand(uv2.shape[:-1] + (3, 4))
    return torch.stack([
        uv1[..., 0, None] * p1[..., 2, :] - p1[..., 0, :],
        uv1[..., 1, None] * p1[..., 2, :] - p1[..., 1, :],
        uv2[..., 0, None] * p2[..., 2, :] - p2[..., 0, :],
        uv2[..., 1, None] * p2[..., 2, :] - p2[..., 1, :],
    ], dim=-2)  # (..., 4, 4)


def triangulate_dlt(p1, p2, uv1, uv2):
    """DLT triangulation: p1, p2 (3, 4) projection matrices (K [R|t]) or
    batched (..., 3, 4); uv1, uv2 (..., 2). Returns (..., 3) points from
    the smallest-eigenvalue eigenvector of A^T A."""
    a = _dlt_rows(p1, p2, uv1, uv2)
    ata = a.transpose(-1, -2) @ a
    _, vecs = torch.linalg.eigh(ata)
    x = vecs[..., :, 0]
    w = x[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return x[..., :3] / w[..., None]


def triangulate_linear3(p1, p2, uv1, uv2):
    """Inhomogeneous DLT: the 4x3 least-squares system A x = b with w = 1,
    solved through its closed-form 3x3 normal equations. Points near
    infinity come out huge and fail the cheirality/reprojection gates."""
    a_full = _dlt_rows(p1, p2, uv1, uv2)
    a = a_full[..., :3]
    b = -a_full[..., 3]
    m = a.transpose(-1, -2) @ a
    atb = torch.einsum("...ij,...i->...j", a, b)
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c10 + m[..., 0, 2] * c20
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18), det)
    inv = torch.stack([
        torch.stack([c00, c01, c02], -1),
        torch.stack([c10, c11, c12], -1),
        torch.stack([c20, c21, c22], -1),
    ], -2) / det[..., None, None]
    return torch.einsum("...ij,...j->...i", inv, atb)


def parallax_cos(pts, c1, c2):
    """Cosine of the parallax angle at each point between camera centers."""
    n1 = pts - c1
    n2 = pts - c2
    d1 = torch.linalg.norm(n1, dim=-1)
    d2 = torch.linalg.norm(n2, dim=-1)
    return torch.sum(n1 * n2, -1) / torch.clamp(d1 * d2, min=1e-12)


def reprojection_error_sq(fx, fy, cx, cy, t_cw, pts_w, uv):
    """Squared pixel reprojection error of world points (N, 3) under one
    pose Tcw (4, 4); returns (err2 (N,), depth (N,))."""
    pc = pts_w @ t_cw[:3, :3].T + t_cw[:3, 3]
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    du = fx * pc[..., 0] * inv_z + cx - uv[..., 0]
    dv = fy * pc[..., 1] * inv_z + cy - uv[..., 1]
    return du * du + dv * dv, z
