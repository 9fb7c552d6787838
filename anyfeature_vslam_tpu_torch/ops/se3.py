"""SE3 / SO3 operations on float32 tensors (port of anyfeature_vslam_tpu/ops/se3.py).

Conventions as in the JAX package: poses are (..., 4, 4) ``T = [[R, t],
[0, 1]]``; tangent vectors are (..., 6) ``xi = (rho, phi)``, translation
first; updates are left-multiplicative ``T <- exp(xi) @ T``. Small-angle
branches use Taylor series selected with ``torch.where`` so nothing is NaN
at theta = 0. Only what the synchronous System needs is ported: the pose
LM, BA and motion prediction, and ``rot_to_quat`` for the trajectory
writers.
"""

from __future__ import annotations

import torch


def hat(v):
    """Skew-symmetric matrix of (..., 3) vectors -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _sin_cos_coeffs_sq(t2):
    """(sin t / t, (1-cos t)/t^2, (t - sin t)/t^3) from the squared angle."""
    small = t2 < 1e-8
    safe_t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(safe_t) / safe_t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(safe_t)) / (safe_t * safe_t))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (safe_t - torch.sin(safe_t)) / (safe_t ** 3))
    return a, b, c


def _eye3_like(k):
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def so3_exp(phi):
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix."""
    t2 = torch.sum(phi * phi, dim=-1)
    a, b, _ = _sin_cos_coeffs_sq(t2)
    k = hat(phi)
    return _eye3_like(k) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def _left_jacobian(phi):
    """SO3 left Jacobian V(phi): integrates translation in the SE3 exp."""
    t2 = torch.sum(phi * phi, dim=-1)
    _, b, c = _sin_cos_coeffs_sq(t2)
    k = hat(phi)
    return _eye3_like(k) + b[..., None, None] * k + c[..., None, None] * (k @ k)


def rt_to_mat(r, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([r, t[..., None]], dim=-1)
    # [0, 0, 0, 1] made on the device (a scalar assignment into a CUDA
    # tensor would copy from the host and synchronise)
    bottom = torch.eye(4, dtype=r.dtype, device=r.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi):
    """(..., 6) tangent (rho, phi) -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return rt_to_mat(so3_exp(phi), t)


def se3_inverse(t_mat):
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    rt = r.transpose(-1, -2)
    return rt_to_mat(rt, -(rt @ t[..., None])[..., 0])


def rot_to_quat(r):
    """(..., 3, 3) -> (..., 4) quaternion (x, y, z, w), w >= 0: Shepperd's
    method, all four candidates computed and the one keyed by the largest
    diagonal combination selected."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    def build(tw, tx, ty, tz):
        return torch.stack([tx, ty, tz, tw], dim=-1)

    def scale(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    s0 = scale(1.0 + tr)
    q0 = build(0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0)
    s1 = scale(1.0 + m00 - m11 - m22)
    q1 = build((m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1)
    s2 = scale(1.0 - m00 + m11 - m22)
    q2 = build((m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2)
    s3 = scale(1.0 - m00 - m11 + m22)
    q3 = build((m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3)
    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
