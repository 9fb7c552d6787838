"""Ground-truth scene and map for the tracked-frame slice (numpy only).

Used by the PyTorch port's tests and by chip_smoke.py, on machines with or
without JAX: it imports numpy and tests/synth_scene.py only (no PIL).

The scene is the benchmark sequence of bench.py / tools/make_synth_sequence.py:
the textured relief plane (15000 blobs, seed 3) seen from a camera with
fx = fy = 0.8125 w, c = (w/2, h/2) and no distortion, moving on a circle of
radius 0.8 m at 2 m height, 150 frames with a 0.2 revisit tail. Frames are
rendered in memory and cut to uint8 as the sequence's PNGs are.

``build_state`` stands in for a mapper: keyframes 0, 4, 8 and 12 are
extracted by a caller-supplied function, their valid keypoints are
back-projected with the rendered ground-truth depth, and each point gets
the map-point geometry of SlamMap.update_point_geometry (single
observation; anyfeature_vslam_tpu/slam/map_state.py:585-608). The block is
padded to 4096 rows, the carry holds keyframe 12's features and matches,
and the reference keyframe is keyframe 12. Tracking then starts at frame 13
with the constant-velocity prediction from the poses of frames 11 and 12.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from synth_scene import PlaneScene, look_down_pose, make_texture  # noqa: E402

SEED = 3
RADIUS = 0.8
N_FRAMES = 150
REVISIT = 0.2
KEYFRAMES = (0, 4, 8, 12)
FIRST_TRACKED = 13
BLOCK_ROWS = 4096
ORB_MAX_SIZE = 1.2 ** 7

# the fused step's thresholds: TrackerConfig defaults
# (anyfeature_vslam_tpu/slam/tracking.py:45-56)
TRACK_PARAMS = dict(
    motion_radius=15.0, match_th=75.0, min_motion_matches=20, refkf_ratio=0.7,
    local_radius=1.0, local_ratio=0.8, min_track_inliers=10,
)


class SliceScene:
    """The benchmark sequence's camera, trajectory and renderer at one
    resolution."""

    def __init__(self, width: int, height: int, n_frames: int = N_FRAMES, seed: int = SEED):
        self.width, self.height = width, height
        self.fx = self.fy = 0.8125 * width
        self.cx, self.cy = width / 2.0, height / 2.0
        self.k = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float64)
        self.scene = PlaneScene(self.k, width, height, seed=seed,
                                tex=make_texture(n_blobs=15000, seed=seed))
        n_circle = int(round(n_frames / (1.0 + REVISIT)))
        self.poses = []
        for i in range(n_frames):
            ang = 2 * np.pi * (i % n_circle) / n_circle
            self.poses.append(look_down_pose(2.5 + RADIUS * np.cos(ang),
                                             2.5 + RADIUS * np.sin(ang), -2.0))

    @property
    def camera(self):
        """Intrinsics as plain numbers (fx, fy, cx, cy, k1, k2, p1, p2, k3,
        width, height)."""
        return dict(fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy, k1=0.0, k2=0.0,
                    p1=0.0, p2=0.0, k3=0.0, width=self.width, height=self.height)

    @property
    def bounds(self):
        """(bounds_lo, bounds_hi) of the undistorted image: no distortion."""
        return (np.array([0.0, 0.0], np.float32),
                np.array([self.width, self.height], np.float32))

    def render(self, i: int):
        """(uint8 image, float32 depth) of frame i."""
        img, depth = self.scene.render_with_depth(self.poses[i])
        return np.clip(img, 0, 255).astype(np.uint8), depth

    def build_state(self, extract, keyframes=KEYFRAMES, block_rows=BLOCK_ROWS):
        """Ground-truth map from the keyframes.

        extract(img8) -> dict of numpy arrays uv_und (N, 2), desc_bits
        (N, 256) uint8, size, angle (N,) float32, valid (N,) bool.
        Returns (carry, ref, block) dicts keyed as anyfeature_vslam_tpu_torch
        .convert expects, plus the last keyframe's features.
        """
        pos, normal, bits, ref_size, ref_dist = [], [], [], [], []
        for kf in keyframes:
            img8, depth = self.render(kf)
            feats = extract(img8)
            t_cw = self.poses[kf].astype(np.float64)
            center = -t_cw[:3, :3].T @ t_cw[:3, 3]
            uv = feats["uv_und"].astype(np.float64)
            xi = np.clip(np.round(uv[:, 0]).astype(np.int64), 1, self.width - 2)
            yi = np.clip(np.round(uv[:, 1]).astype(np.int64), 1, self.height - 2)
            win = np.stack([depth[yi + dy, xi + dx] for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
            z = depth[yi, xi].astype(np.float64)
            # skip keypoints on a depth edge (platform rims): their nearest
            # depth sample may belong to the other surface
            ok = feats["valid"] & (win.min(0) > 0) & (win.max(0) - win.min(0) < 0.01 * z)
            match = np.full(uv.shape[0], -1, np.int32)
            rays = np.stack([(uv[:, 0] - self.cx) / self.fx, (uv[:, 1] - self.cy) / self.fy,
                             np.ones(uv.shape[0])], 1)
            p_c = rays * z[:, None]
            p_w = (p_c - t_cw[:3, 3]) @ t_cw[:3, :3]  # R^T (p_c - t)
            for s in np.nonzero(ok)[0]:
                match[s] = len(pos)
                po = p_w[s] - center
                d = float(np.linalg.norm(po))
                pos.append(p_w[s])
                normal.append(po / max(d, 1e-9))
                bits.append(feats["desc_bits"][s])
                ref_size.append(float(feats["size"][s]))
                ref_dist.append(d)
        n_pts = len(pos)
        if n_pts > block_rows:
            raise ValueError(f"{n_pts} map points do not fit a {block_rows}-row block")
        pos = np.asarray(pos, np.float32)
        ref_size = np.asarray(ref_size, np.float64)
        ref_dist = np.asarray(ref_dist, np.float64)

        def pad(a, fill=0):
            a = np.asarray(a)
            out = np.full((block_rows,) + a.shape[1:], fill, a.dtype)
            out[:n_pts] = a
            return out

        block = dict(
            blk_ids=pad(np.arange(n_pts, dtype=np.int32), -1),
            blk_pos=pad(pos),
            blk_normal=pad(np.asarray(normal, np.float32)),
            blk_min_dist=pad((0.8 * ref_dist * ref_size / ORB_MAX_SIZE).astype(np.float32)),
            blk_max_dist=pad((1.2 * ref_dist * ref_size).astype(np.float32)),
            blk_ref_size=pad(ref_size.astype(np.float32)),
            blk_ref_dist=pad(ref_dist.astype(np.float32)),
            blk_bits=pad(np.asarray(bits, np.uint8)),
            blk_valid=pad(np.ones(n_pts, bool), False),
        )
        # carry and reference keyframe: the last keyframe, laid out as
        # Tracker._build_fast_carry / _build_fast_state build them
        has = match >= 0
        match_pos = pos[np.maximum(match, 0)]
        carry = dict(uv=feats["uv_und"], bits=feats["desc_bits"], size=feats["size"],
                     angle=feats["angle"], match_pt=match, match_pos=match_pos)
        ref = dict(ref_bits=feats["desc_bits"], ref_angle=feats["angle"], ref_has=has,
                   ref_match_pt=np.where(has, match, -1).astype(np.int32),
                   ref_match_pos=match_pos)
        return carry, ref, block


def pose_error(t_cw, t_cw_gt):
    """(rotation error in degrees, camera-centre error in metres)."""
    t_cw = np.asarray(t_cw, np.float64)
    t_gt = np.asarray(t_cw_gt, np.float64)
    r_rel = t_cw[:3, :3] @ t_gt[:3, :3].T
    # angle from both the symmetric and antisymmetric parts: arccos of
    # the trace alone cannot resolve the small angles of a float32 pose
    w = np.array([r_rel[2, 1] - r_rel[1, 2], r_rel[0, 2] - r_rel[2, 0], r_rel[1, 0] - r_rel[0, 1]])
    ang = np.degrees(np.arctan2(0.5 * np.linalg.norm(w), 0.5 * (np.trace(r_rel) - 1.0)))
    c = -t_cw[:3, :3].T @ t_cw[:3, 3]
    c_gt = -t_gt[:3, :3].T @ t_gt[:3, 3]
    return float(ang), float(np.linalg.norm(c - c_gt))


class LoopScene:
    """The two-session loop-closure sequence of tests/test_loop_live.py,
    rendered in memory: tools/make_synth_sequence.py with
    ``trajectory:two_circles_revisit texture:distinct seed:3`` (a lap of
    circle A, a transit, a lap of circle B with a height oscillation, a
    transit back, a revisit lap of A), the same camera as SliceScene and
    the same uint8 frames as the generator's PNGs (no noise).
    ``session_a`` and ``session_b`` are the frame ranges the test gives
    its two sessions."""

    def __init__(self, width: int, height: int, n_frames: int = 360, seed: int = SEED):
        self.width, self.height = width, height
        self.fx = self.fy = 0.8125 * width
        self.cx, self.cy = width / 2.0, height / 2.0
        k = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float64)
        self.scene = PlaneScene(k, width, height, seed=seed,
                                tex=make_texture(n_blobs=15000, seed=seed, distinct=True))
        n, radius = n_frames, RADIUS
        na, nt1 = int(round(0.30 * n)), int(round(0.07 * n))
        nb, nt2 = int(round(0.30 * n)), int(round(0.07 * n))
        ne = n - na - nt1 - nb - nt2
        bx = 2.5 + 3.5 * radius
        p = []
        for i in range(na):
            ang = 2 * np.pi * i / na
            p.append(look_down_pose(2.5 + radius * np.cos(ang), 2.5 + radius * np.sin(ang), -2.0))
        for i in range(nt1):
            f = (i + 1) / nt1
            p.append(look_down_pose((2.5 + radius) * (1 - f) + (bx + radius) * f, 2.5, -2.0))
        for i in range(nb):
            ang = 2 * np.pi * i / nb
            p.append(look_down_pose(bx + radius * np.cos(ang), 2.5 + radius * np.sin(ang),
                                    -2.0 - 0.5 * np.sin(ang)))
        for i in range(nt2):
            f = (i + 1) / nt2
            p.append(look_down_pose((bx + radius) * (1 - f) + (2.5 + radius) * f, 2.5, -2.0))
        for i in range(ne):
            ang = 2 * np.pi * i / na
            p.append(look_down_pose(2.5 + radius * np.cos(ang), 2.5 + radius * np.sin(ang), -2.0))
        self.poses = p
        self.session_a = range(na)
        self.session_b = range(na + nt1, n)

    camera = SliceScene.camera

    def render(self, i: int):
        """uint8 image of frame i."""
        return np.clip(self.scene.render(self.poses[i]), 0, 255).astype(np.uint8)
