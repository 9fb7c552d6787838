"""The benchmark's scene, camera path and frames, in PyTorch.

The scene is the relief plane the repository's synthetic sequences use: a
textured ground plane z = 0 over [0, extent]^2 metres (square blobs painted
from a numpy generator seeded with the scene seed), with raised square
platforms (z = -height, toward the camera) that give it real 3D relief.
The camera hangs below the plane at z = -height and looks along +z. A
frame is ray-cast on the device: the nearest platform top a ray meets,
else the ground, sampled bilinearly from the texture; the ray parameter is
the depth. This is a PyTorch copy of the numpy renderer in the
repository's test scenes (same texture, same platforms, same arithmetic),
so the renders agree with it to rounding.

``camera_path`` turns a traffic file's ``path`` block into world-to-camera
poses, one per frame at the camera's rate. ``render_frames`` makes the
uint8 frames: the noise-free render is fixed by the traffic file, and the
run's seed draws only zero-mean Gaussian read noise, fresh for each frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch

VOID_GRAY = 20.0  # what a ray that meets nothing sees
GROUND_GRAY = 40.0


def make_texture(size: int, n_blobs: int, seed: int) -> np.ndarray:
    """(size, size) float32 texture: flat squares of random gray on a flat
    background, painted in the order drawn (later squares cover earlier)."""
    rng = np.random.default_rng(seed)
    tex = np.full((size, size), GROUND_GRAY, np.float32)
    ys = rng.integers(8, size - 8, n_blobs)
    xs = rng.integers(8, size - 8, n_blobs)
    vals = rng.uniform(80, 255, n_blobs)
    half = rng.integers(2, 6, n_blobs)
    for y, x, v, h in zip(ys, xs, vals, half):
        tex[y - h:y + h, x - h:x + h] = v
    return tex


def make_platforms(seed: int, extent: float, relief: float, n_platforms: int) -> np.ndarray:
    """(n, 5) float64 rows (x0, x1, y0, y1, height) of the raised platforms."""
    rng = np.random.default_rng(seed + 1)
    rows = []
    for _ in range(n_platforms if relief > 0 else 0):
        cx, cy = rng.uniform(0, extent, 2)
        half = rng.uniform(0.08, 0.3)
        z = rng.uniform(0.1, relief)
        rows.append((cx - half, cx + half, cy - half, cy + half, z))
    return np.asarray(rows, np.float64).reshape(-1, 5)


class ReliefPlane:
    """The scene of a traffic file's ``scene`` block, on `device`."""

    def __init__(self, spec: dict, device):
        self.device = torch.device(device)
        self.extent = float(spec["extent_m"])
        tex = make_texture(int(spec["texture_px"]), int(spec["blobs"]), int(spec["seed"]))
        self.tex = torch.from_numpy(tex).to(self.device)
        self.scale = tex.shape[0] / self.extent  # texture pixels per metre
        self.platforms = make_platforms(int(spec["seed"]), self.extent, float(spec["relief_m"]),
                                        int(spec["platforms"]))

    def _sample(self, x_m, y_m):
        """Bilinear texture values (float32) at plane points, and whether
        each lies on the texture."""
        n = self.tex.shape[0]
        x = x_m * self.scale
        y = y_m * self.scale
        ok = (x >= 0) & (x < n - 1) & (y >= 0) & (y < n - 1)
        x = torch.clamp(x, 0, n - 2)
        y = torch.clamp(y, 0, n - 2)
        x0 = x.to(torch.int64)
        y0 = y.to(torch.int64)
        fx = (x - x0).to(torch.float32)
        fy = (y - y0).to(torch.float32)
        t = self.tex
        val = (t[y0, x0] * (1 - fx) * (1 - fy) + t[y0, x0 + 1] * fx * (1 - fy)
               + t[y0 + 1, x0] * (1 - fx) * fy + t[y0 + 1, x0 + 1] * fx * fy)
        return val, ok

    def render(self, cam: dict, t_cw: np.ndarray):
        """(gray (B, H, W) float32, depth (B, H, W) float32, -1 where no
        surface) of the views T_cw (B, 4, 4) through the pinhole `cam`
        (fx, fy, cx, cy, width, height)."""
        dev = self.device
        w, h = int(cam["width"]), int(cam["height"])
        t_wc = torch.linalg.inv(torch.as_tensor(np.asarray(t_cw, np.float64), device=dev))
        b = t_wc.shape[0]
        vs, us = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                                torch.arange(w, dtype=torch.float64, device=dev), indexing="ij")
        rays = torch.stack([(us.reshape(-1) - cam["cx"]) / cam["fx"],
                            (vs.reshape(-1) - cam["cy"]) / cam["fy"],
                            torch.ones(h * w, dtype=torch.float64, device=dev)])
        d = t_wc[:, :3, :3] @ rays                               # (B, 3, HW)
        c = t_wc[:, :3, 3]                                       # (B, 3)
        cx, cy, cz = (c[:, k:k + 1] for k in range(3))
        best = torch.full((b, h * w), math.inf, dtype=torch.float64, device=dev)
        val = torch.full((b, h * w), VOID_GRAY, dtype=torch.float32, device=dev)
        shift = self.extent * 0.473
        for x0, x1, y0, y1, hz in self._visible_platforms(cam, t_wc):
            lam = (-hz - cz) / d[:, 2]
            px = cx + lam * d[:, 0]
            py = cy + lam * d[:, 1]
            hit = (lam > 0) & (px >= x0) & (px < x1) & (py >= y0) & (py < y1) & (lam < best)
            # platform tops sample a shifted texture region, so they do not
            # repeat the ground beneath them
            v, ok = self._sample(torch.remainder(px + shift, self.extent),
                                 torch.remainder(py + shift, self.extent))
            val = torch.where(hit & ok, v, val)
            best = torch.where(hit, lam, best)
        lam = -cz / d[:, 2]
        px = cx + lam * d[:, 0]
        py = cy + lam * d[:, 1]
        hit = (lam > 0) & (lam < best)
        v, ok = self._sample(px, py)
        val = torch.where(hit & ok, v, val)
        best = torch.where(hit, lam, best)
        depth = torch.where(torch.isfinite(best), best, torch.full_like(best, -1.0))
        return val.reshape(b, h, w), depth.to(torch.float32).reshape(b, h, w)

    def _visible_platforms(self, cam, t_wc):
        """The platforms whose square meets the views' ground footprints
        (a platform top lies nearer than the ground, so its visible part
        lies inside the ground footprint's box)."""
        corners = np.array([[0, 0], [cam["width"], 0], [0, cam["height"]],
                            [cam["width"], cam["height"]]], np.float64)
        half = float(np.max(np.hypot((corners[:, 0] - cam["cx"]) / cam["fx"],
                                     (corners[:, 1] - cam["cy"]) / cam["fy"])))
        c = t_wc[:, :3, 3].cpu().numpy()
        r = half * float(np.max(np.abs(c[:, 2]))) + 0.05
        lo_x, hi_x = c[:, 0].min() - r, c[:, 0].max() + r
        lo_y, hi_y = c[:, 1].min() - r, c[:, 1].max() + r
        p = self.platforms
        keep = (p[:, 1] >= lo_x) & (p[:, 0] <= hi_x) & (p[:, 3] >= lo_y) & (p[:, 2] <= hi_y)
        return [tuple(float(v) for v in row) for row in p[keep]]


def look_down_pose(x: float, y: float, z: float, yaw: float) -> np.ndarray:
    """World-to-camera pose (4, 4) float64 of a camera at (x, y, z) looking
    along +z, turned by `yaw` radians about its optical axis."""
    cz, sz = math.cos(yaw), math.sin(yaw)
    t_wc = np.eye(4)
    t_wc[:3, :3] = [[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]]
    t_wc[:3, 3] = [x, y, z]
    return np.linalg.inv(t_wc)


def _polyline_point(points: np.ndarray, s: float):
    """The point at arc length s along a polyline; None past its end."""
    for a, b in zip(points[:-1], points[1:]):
        seg = float(np.linalg.norm(b - a))
        if s <= seg:
            return a + (b - a) * (s / seg)
        s -= seg
    return None


def camera_path(path: dict, n_frames: int, fps: float) -> np.ndarray:
    """(n_frames, 4, 4) float64 world-to-camera poses of a traffic file's
    ``path`` block. kind "polyline": the waypoints at a constant speed;
    kind "sweep": back and forth between two points, starting at rest at
    the first, with a period of ``period_frames``. Both keep the camera
    ``height_m`` below the plane and turn it about its axis by
    ``yaw_amplitude_deg`` * sin(2 pi frame / ``yaw_period_frames``)."""
    pts = np.asarray(path["waypoints"], np.float64)
    amp = math.radians(float(path.get("yaw_amplitude_deg", 0.0)))
    yaw_period = float(path.get("yaw_period_frames", 1.0))
    z = -float(path["height_m"])
    poses = np.empty((n_frames, 4, 4))
    for i in range(n_frames):
        if path["kind"] == "polyline":
            p = _polyline_point(pts, float(path["speed_m_s"]) * i / fps)
            if p is None:
                raise ValueError(f"the path ends before frame {i} of {n_frames}")
        elif path["kind"] == "sweep":
            f = 0.5 * (1.0 - math.cos(2.0 * math.pi * i / float(path["period_frames"])))
            p = pts[0] + (pts[1] - pts[0]) * f
        else:
            raise ValueError(f"unknown path kind {path['kind']!r}")
        poses[i] = look_down_pose(p[0], p[1], z, amp * math.sin(2.0 * math.pi * i / yaw_period))
    return poses


def render_frames(plane: ReliefPlane, cam: dict, poses: np.ndarray, noise_sigma: float,
                  seed: int, chunk: int) -> torch.Tensor:
    """(N, H, W) uint8 frames in pinned host memory (plain host memory when
    the plane is on the CPU): each view rendered on the plane's device,
    plus zero-mean Gaussian noise of `noise_sigma` gray levels drawn from
    a generator seeded with `seed`, clipped to [0, 255] and cut to uint8
    as a camera's driver delivers them. Chunks of `chunk` frames draw
    their noise in order, so one seed gives the same frames."""
    dev = plane.device
    h, w = int(cam["height"]), int(cam["width"])
    out = torch.empty((len(poses), h, w), dtype=torch.uint8,
                      pin_memory=dev.type == "cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    for s in range(0, len(poses), chunk):
        img, _ = plane.render(cam, poses[s:s + chunk])
        if noise_sigma > 0:
            img = img + noise_sigma * torch.randn(img.shape, generator=gen, device=dev)
        out[s:s + chunk].copy_(torch.clamp(img, 0, 255).to(torch.uint8))
    return out
