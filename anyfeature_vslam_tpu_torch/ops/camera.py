"""Pinhole camera with radial-tangential distortion (port of
anyfeature_vslam_tpu/ops/camera.py).

``CameraParams`` holds each intrinsic as a 0-d float32 tensor on one
device, so per-keypoint math never copies a scalar to or from the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CameraParams(NamedTuple):
    """Intrinsics fx, fy, cx, cy and distortion (k1, k2, p1, p2, k3) as 0-d
    float32 tensors; image size as Python ints."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    k3: torch.Tensor
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
               width=640, height=480, *, device):
        f = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)
        return CameraParams(f(fx), f(fy), f(cx), f(cy), f(k1), f(k2), f(p1),
                            f(p2), f(k3), int(width), int(height))

    @property
    def k_matrix(self):
        """(3, 3) float32 intrinsic matrix on the parameters' device."""
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx]),
            torch.stack([z, self.fy, self.cy]),
            torch.stack([z, z, o]),
        ])


def project(cam: CameraParams, pts_cam):
    """Camera-frame points (..., 3) -> undistorted pixel coords (..., 2)
    and depth (...)."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xn = pts_cam[..., :2] * inv_z[..., None]
    return torch.stack([cam.fx * xn[..., 0] + cam.cx, cam.fy * xn[..., 1] + cam.cy], -1), z


def undistort_points(cam: CameraParams, uv, num_iters: int = 10):
    """Undistort pixel keypoints (..., 2) -> ideal pixel coords, with the
    same fixed-point iteration (10 steps) as cv::undistortPoints."""
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    x, y = xd, yd
    for _ in range(num_iters):
        r2 = x * x + y * y
        radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        inv = 1.0 / torch.clamp(radial, min=1e-6)
        x = (xd - dx) * inv
        y = (yd - dy) * inv
    return torch.stack([cam.fx * x + cam.cx, cam.fy * y + cam.cy], dim=-1)


def undistorted_bounds(cam: CameraParams):
    """Image bounds after undistortion (reference src/Frame.cc:202-218):
    (min_x, max_x, min_y, max_y) as 0-d float32 tensors."""
    corners = torch.tensor(
        [[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height], [cam.width, cam.height]],
        dtype=torch.float32, device=cam.fx.device,
    )
    und = undistort_points(cam, corners)
    return und[:, 0].min(), und[:, 0].max(), und[:, 1].min(), und[:, 1].max()
