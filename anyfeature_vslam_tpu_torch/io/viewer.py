"""Offline map and frame views (port of anyfeature_vslam_tpu/io/viewer.py).

The reference's Pangolin viewer (reference src/Viewer.cc:80-135,
MapDrawer.cc, FrameDrawer.cc: an OpenGL window with the map, keyframe
frusta and the current frame's overlay) is rendered headlessly here: a
top-down orthographic SVG of map points, keyframe centres and the frame
trajectory, and the current frame with its keypoints boxed (green: tracked
to a map point, blue: not). Host numpy over the host map, as in the JAX
package. The overlay's PNG is written with the standard library (zlib,
struct; ``png.write_png``): 8-bit RGB, the tracker's state in a ``tEXt``
chunk keyed ``slam_state``.
"""

from __future__ import annotations

import numpy as np

from .png import write_png


def _project_axes(pts, axes):
    return pts[:, axes[0]], pts[:, axes[1]]


def render_map_svg(slam_map, path: str, trajectory=None, axes=(0, 2), size: int = 900):
    """Write an SVG of the map. axes: which world axes map to (x, y) of the
    figure (default x-z like the reference's aerial MapDrawer view)."""
    pts = slam_map.pt_pos[slam_map.pt_valid]
    centers = [-slam_map.kf_pose[kf][:3, :3].T @ slam_map.kf_pose[kf][:3, 3]
               for kf in slam_map.keyframe_ids()]
    centers = np.asarray(centers) if centers else np.zeros((0, 3))

    everything = [a for a in (pts, centers) if len(a)]
    traj = None
    if trajectory is not None and len(trajectory):
        traj = np.asarray(trajectory)
        everything.append(traj)
    allpts = np.concatenate(everything) if everything else np.zeros((1, 3))
    px, py = _project_axes(allpts, axes)
    lo = np.array([px.min(), py.min()]) - 0.2
    hi = np.array([px.max(), py.max()]) + 0.2
    scale = (size - 40) / np.maximum(hi - lo, 1e-6).max()

    def to_screen(p):
        x, y = _project_axes(np.atleast_2d(p), axes)
        return 20 + (x - lo[0]) * scale, size - 20 - (y - lo[1]) * scale

    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}" '
             f'viewBox="0 0 {size} {size}"><rect width="100%" height="100%" fill="#101018"/>']
    if len(pts):
        sx, sy = to_screen(pts)
        parts.append("".join(
            f'<circle cx="{x:.1f}" cy="{y:.1f}" r="1" fill="#8fd0ff" fill-opacity="0.6"/>'
            for x, y in zip(sx, sy)))
    if traj is not None:
        sx, sy = to_screen(traj)
        d = "M" + " L".join(f"{x:.1f},{y:.1f}" for x, y in zip(sx, sy))
        parts.append(f'<path d="{d}" stroke="#ffcf5e" stroke-width="1.2" fill="none"/>')
    if len(centers):
        sx, sy = to_screen(centers)
        parts.append("".join(
            f'<rect x="{x - 2.5:.1f}" y="{y - 2.5:.1f}" width="5" height="5" '
            f'fill="none" stroke="#7dffa0" stroke-width="1"/>'
            for x, y in zip(sx, sy)))
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("".join(parts))
    return path


def render_frame_overlay(img, feats, matches=None, state_text: str = "", path=None):
    """Current-frame overlay (reference FrameDrawer::DrawFrame,
    src/FrameDrawer.cc): keypoints drawn as boxes, green for keypoints
    tracked to a map point, blue for untracked detections. Returns an (H, W,
    3) uint8 image; writes a PNG when `path` is given, with `state_text` in
    its ``slam_state`` text chunk."""
    h, w = img.shape[:2]
    canvas = np.clip(img, 0, 255).astype(np.uint8)
    rgb = np.stack([canvas] * 3, axis=-1)

    xy = np.asarray(feats["xy"])
    valid = np.asarray(feats["valid"])
    tracked = (np.asarray(matches) >= 0) if matches is not None else np.zeros(len(xy), bool)

    def draw_box(u, v, color, half=3):
        x0, x1 = max(u - half, 0), min(u + half + 1, w)
        y0, y1 = max(v - half, 0), min(v + half + 1, h)
        rgb[y0:y1, x0, :] = color
        rgb[y0:y1, x1 - 1, :] = color
        rgb[y0, x0:x1, :] = color
        rgb[y1 - 1, x0:x1, :] = color

    green, blue = (90, 230, 90), (110, 160, 255)
    for i in np.nonzero(valid)[0]:
        u, v = int(round(float(xy[i, 0]))), int(round(float(xy[i, 1])))
        if 0 <= u < w and 0 <= v < h:
            draw_box(u, v, green if tracked[i] else blue)
    if path is not None:
        write_png(path, rgb, {"slam_state": state_text} if state_text else None)
    return rgb


def trajectory_centers(trajectory, slam_map):
    """Frame camera centres from the stored (ts, T_cur_ref, ref_uid, lost)
    list (culled anchors resolved through the retired-keyframe chain)."""
    out = []
    for ts, t_cr, ref_uid, lost in trajectory:
        if lost:
            continue
        t_cw = slam_map.resolve_anchor(t_cr, ref_uid)
        if t_cw is None:
            continue
        out.append(-t_cw[:3, :3].T @ t_cw[:3, 3])
    return np.asarray(out) if out else np.zeros((0, 3))
