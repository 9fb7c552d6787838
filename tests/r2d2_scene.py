"""A precomputed-feature (r2d2_128) landmark scene, written as the files
the reference's r2d2 extractor reads (reference
src/Feature_r2d2_128.cpp:21-54, src/Image.cpp:18-23):

    <root>/rgb/<stem>.png                     (only with write_png=True)
    <root>/r2d2/keypoints/<stem>.bin          float64 rows [x, y, size]
    <root>/r2d2/scores/<stem>.bin             float64 rows [score]
    <root>/r2d2/descriptors/<stem>.bin        float64 rows [128 dims]

3D landmarks with fixed unit 128-d descriptors, seen by a camera that
translates sideways (and a little forward) at constant speed, looking
along +z. Each visible landmark becomes a keypoint with 0.2 px jitter,
its descriptor with 0.01 noise per dimension, and a score that is the
landmark's own fixed value plus 0.01 jitter, so consecutive frames keep
mostly the same top-scoring points. Numpy only (the card's machine has
no PIL): the images the System takes are flat gray arrays
(``R2d2Scene.image``); ``write_png`` also saves them for the CLI.
"""

import os

import numpy as np

STEP = np.array([0.05, 0.0, 0.01])   # camera motion per frame (map units)


class R2d2Scene:
    def __init__(self, width=320, height=240, n_frames=8, n_pts=600, seed=0, focal=None):
        self.width, self.height, self.n_frames = width, height, n_frames
        f = float(focal if focal is not None else width)
        self.fx = self.fy = f
        self.cx, self.cy = width / 2.0, height / 2.0
        rng = np.random.default_rng(seed)
        # landmarks span the view along the whole path
        span = STEP[0] * n_frames
        half_w, half_h = 9.0 * self.cx / f, 9.0 * self.cy / f
        self.pts = np.stack([rng.uniform(-half_w, half_w + span, n_pts),
                             rng.uniform(-half_h, half_h, n_pts),
                             rng.uniform(4.0, 9.0, n_pts)], axis=1)
        d = rng.normal(size=(n_pts, 128))
        self.descs = d / np.linalg.norm(d, axis=1, keepdims=True)
        self.score = rng.uniform(0.5, 1.0, n_pts)
        self.rng = np.random.default_rng(seed + 1)
        self.camera = dict(fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy, k1=0.0, k2=0.0,
                           p1=0.0, p2=0.0, k3=0.0, width=width, height=height)
        # T_cw per frame: camera centre STEP * i, identity rotation
        self.poses = []
        for i in range(n_frames):
            t = np.eye(4)
            t[:3, 3] = -STEP * i
            self.poses.append(t)

    def image(self):
        """The flat gray (H, W) uint8 image every frame shows."""
        return np.full((self.height, self.width), 128, np.uint8)

    def features(self, i):
        """Frame i's (keypoints (n, 3), scores (n,), descriptors (n, 128))
        as float64, in landmark order."""
        pc = self.pts - STEP * i
        u = self.fx * pc[:, 0] / pc[:, 2] + self.cx
        v = self.fy * pc[:, 1] / pc[:, 2] + self.cy
        vis = (pc[:, 2] > 0.1) & (u >= 4) & (u < self.width - 4) & (v >= 4) & (v < self.height - 4)
        n = int(vis.sum())
        rng = self.rng
        kps = np.stack([u[vis] + rng.normal(0, 0.2, n), v[vis] + rng.normal(0, 0.2, n),
                        np.full(n, 2.0)], axis=1)
        scores = self.score[vis] + rng.normal(0, 0.01, n)
        descs = self.descs[vis] + rng.normal(0, 0.01, (n, 128))
        return kps, scores, descs

    def write(self, root, write_png=False):
        """Write the sequence under root (calibration, rgb.txt, ground truth
        and the r2d2 tree); returns the image paths, one per frame."""
        os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
        for sub in ("keypoints", "scores", "descriptors"):
            os.makedirs(os.path.join(root, "r2d2", sub), exist_ok=True)
        with open(os.path.join(root, "calibration.yaml"), "w") as f:
            f.write(f"Camera.fx: {self.fx}\nCamera.fy: {self.fy}\nCamera.cx: {self.cx}\n"
                    f"Camera.cy: {self.cy}\nCamera.w: {self.width}\nCamera.h: {self.height}\n"
                    "Camera.fps: 30.0\n")
        if write_png:
            from PIL import Image
        paths, lines, gt = [], [], []
        for i in range(self.n_frames):
            stem = f"{i:06d}"
            kps, scores, descs = self.features(i)
            for sub, arr in (("keypoints", kps), ("scores", scores), ("descriptors", descs)):
                arr.astype(np.float64).tofile(os.path.join(root, "r2d2", sub, stem + ".bin"))
            path = os.path.join(root, "rgb", stem + ".png")
            if write_png:
                Image.fromarray(self.image()).save(path)
            paths.append(path)
            lines.append(f"{i / 30.0:.6f} rgb/{stem}.png")
            c = STEP * i
            gt.append(f"{i / 30.0:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} 0 0 0 1")
        with open(os.path.join(root, "rgb.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(root, "groundtruth.txt"), "w") as f:
            f.write("\n".join(gt) + "\n")
        return paths
