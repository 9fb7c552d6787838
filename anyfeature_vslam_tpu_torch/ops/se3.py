"""SE3 / SO3 operations on float32 tensors (port of anyfeature_vslam_tpu/ops/se3.py).

Conventions as in the JAX package: poses are (..., 4, 4) ``T = [[R, t],
[0, 1]]``; tangent vectors are (..., 6) ``xi = (rho, phi)``, translation
first; updates are left-multiplicative ``T <- exp(xi) @ T``. Small-angle
branches use Taylor series selected with ``torch.where`` so nothing is NaN
at theta = 0. Sim3 elements are (r, t, s) triples acting as ``s R x + t``;
their tangent is (..., 7) ``(rho, phi, sigma)`` with ``s = exp(sigma)``
(loop closing: ops/sim3.py, ops/pose_graph.py).
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


def so3_log(r):
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector: theta from
    atan2 of the antisymmetric part (smooth at the identity), the axis from
    the diagonal of R near pi."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    wn2 = torch.sum(w * w, dim=-1)
    small = wn2 < 1e-12
    safe_wn = torch.sqrt(torch.where(small, torch.ones_like(wn2), wn2))
    sin_theta = 0.5 * safe_wn
    theta = torch.atan2(sin_theta, cos_theta)
    near_pi = cos_theta < -0.999
    safe_sin = torch.where(small | near_pi, torch.ones_like(sin_theta), sin_theta)
    generic = w * (theta / (2.0 * safe_sin))[..., None]
    taylor = w * 0.5
    diag = torch.stack([r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag - cos_theta[..., None])
                        / torch.clamp(1.0 - cos_theta[..., None], min=1e-8), min=0.0)
    axis = torch.sqrt(axis2) * torch.where(w >= 0, 1.0, -1.0)
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=1e-8)
    near_pi_val = axis * theta[..., None]
    return torch.where(small[..., None], taylor,
                       torch.where(near_pi[..., None], near_pi_val, generic))


def _left_jacobian(phi):
    """SO3 left Jacobian V(phi): integrates translation in the SE3 exp."""
    t2 = torch.sum(phi * phi, dim=-1)
    _, b, c = _sin_cos_coeffs_sq(t2)
    k = hat(phi)
    return _eye3_like(k) + b[..., None, None] * k + c[..., None, None] * (k @ k)


def _left_jacobian_inv(phi):
    t2 = torch.sum(phi * phi, dim=-1)
    small = t2 < 1e-8
    safe_t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    half = safe_t * 0.5
    cot_coeff = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                            (1.0 - half * torch.cos(half) / torch.sin(half)) / (safe_t * safe_t))
    k = hat(phi)
    return _eye3_like(k) - 0.5 * k + cot_coeff[..., None, None] * (k @ k)


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


def se3_log(t_mat):
    """(..., 4, 4) transform -> (..., 6) tangent (rho, phi)."""
    phi = so3_log(t_mat[..., :3, :3])
    rho = (_left_jacobian_inv(phi) @ t_mat[..., :3, 3][..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(t_mat):
    r = t_mat[..., :3, :3]
    t = t_mat[..., :3, 3]
    rt = r.transpose(-1, -2)
    return rt_to_mat(rt, -(rt @ t[..., None])[..., 0])


def transform_points(t_mat, pts):
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    return pts @ t_mat[..., :3, :3].transpose(-1, -2) + t_mat[..., None, :3, 3]


def quat_to_rot(q):
    """(..., 4) quaternion (x, y, z, w) -> (..., 3, 3). Normalizes q."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


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


# --------------------------------------------------------------------- Sim3


def sim3_to_mat(r, t, s):
    """(..., 3, 3), (..., 3), (...,) -> (..., 4, 4) with sR in the top block."""
    return rt_to_mat(r * s[..., None, None], t)


def sim3_inverse(r, t, s):
    rt = r.transpose(-1, -2)
    s_inv = 1.0 / s
    return rt, -(s_inv[..., None] * (rt @ t[..., None])[..., 0]), s_inv


def sim3_transform(r, t, s, pts):
    """Apply Sim3 (s R x + t) to (..., N, 3)."""
    return s[..., None, None] * (pts @ r.transpose(-1, -2)) + t[..., None, :]


def sim3_compose(a, b):
    """Compose Sim3 triples (r, t, s): a o b (apply b first)."""
    ra, ta, sa = a
    rb, tb, sb = b
    return ra @ rb, sa[..., None] * (ra @ tb[..., None])[..., 0] + ta, sa * sb


def sim3_inv(a):
    return sim3_inverse(*a)


def _sim3_w(phi, sigma):
    """The Sim3 'W' matrix, t = W rho in sim3_exp7 (Strasdat's closed
    form; the sigma ~ 0 and theta ~ 0 branches selected with torch.where)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    s = torch.exp(sigma)
    om = hat(phi)
    om2 = om @ om
    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta2 < 1e-10
    safe_sigma = torch.where(small_sigma, torch.ones_like(sigma), sigma)
    safe_theta = torch.where(small_theta, torch.ones_like(theta), theta)
    # sigma ~ 0
    a_s0 = torch.where(small_theta, 0.5 * torch.ones_like(theta),
                       (1.0 - torch.cos(safe_theta)) / (safe_theta * safe_theta))
    b_s0 = torch.where(small_theta, torch.ones_like(theta) / 6.0,
                       (safe_theta - torch.sin(safe_theta)) / (safe_theta ** 3))
    c_s0 = torch.ones_like(sigma)
    # general sigma, with its theta ~ 0 sub-branch
    c_g = (s - 1.0) / safe_sigma
    a_g_t0 = ((safe_sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma)
    b_g_t0 = ((0.5 * safe_sigma * safe_sigma - safe_sigma + 1.0) * s - 1.0) / (safe_sigma ** 3)
    aa = s * torch.sin(safe_theta)
    bb = s * torch.cos(safe_theta)
    cc = theta2 + sigma * sigma
    cc = torch.where(cc < 1e-24, torch.ones_like(cc), cc)
    a_g = (aa * safe_sigma + (1.0 - bb) * safe_theta) / (safe_theta * cc)
    b_g = (c_g - ((bb - 1.0) * safe_sigma + aa * safe_theta) / cc) / (safe_theta * safe_theta)
    a_coef = torch.where(small_sigma, a_s0, torch.where(small_theta, a_g_t0, a_g))
    b_coef = torch.where(small_sigma, b_s0, torch.where(small_theta, b_g_t0, b_g))
    c_coef = torch.where(small_sigma, c_s0, c_g)
    return (c_coef[..., None, None] * _eye3_like(om) + a_coef[..., None, None] * om
            + b_coef[..., None, None] * om2)


def sim3_exp7(xi):
    """(..., 7) tangent (rho, phi, sigma) -> Sim3 triple (r, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_sim3_w(phi, sigma) @ rho[..., None])[..., 0]
    return so3_exp(phi), t, torch.exp(sigma)


def sim3_log7(r, t, s):
    """Sim3 triple -> (..., 7) tangent (rho, phi, sigma)."""
    sigma = torch.log(torch.clamp(s, min=1e-12))
    phi = so3_log(r)
    rho = torch.linalg.solve(_sim3_w(phi, sigma), t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)



def jacfwd(fn, *xs):
    """Jacobians of fn's outputs (a tuple of tensors) with respect to each
    input x_i of shape (..., n_i), by forward-mode AD in one dual pass:
    the inputs are replicated along a new leading axis of sum(n_i) rows,
    row k carrying the k-th basis tangent, so fn must broadcast over
    leading axes. Returns, per input, a tuple of (out.shape + (n_i,))
    Jacobians. The counterpart of ``jax.jacfwd`` for the LMs of
    ops/sim3.py and ops/pose_graph.py."""
    import torch.autograd.forward_ad as fwd

    sizes = [x.shape[-1] for x in xs]
    n = sum(sizes)
    with fwd.dual_level():
        duals, off = [], 0
        for x, m in zip(xs, sizes):
            tan = torch.zeros((n,) + x.shape, dtype=x.dtype, device=x.device)
            eye = torch.eye(m, dtype=x.dtype, device=x.device)
            tan[off:off + m] = eye.view((m,) + (1,) * (x.dim() - 1) + (m,)).expand((m,) + x.shape)
            duals.append(fwd.make_dual(x.expand((n,) + x.shape).clone(), tan))
            off += m
        tans = [fwd.unpack_dual(o).tangent for o in fn(*duals)]
    out, off = [], 0
    for m in sizes:
        out.append(tuple(t[off:off + m].movedim(0, -1) for t in tans))
        off += m
    return tuple(out)
