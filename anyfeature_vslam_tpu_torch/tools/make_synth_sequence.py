"""Render a synthetic benchmark sequence to disk in VSLAM-LAB layout.

Produces what the reference binary consumes (reference
src/vslamlab_anyfeature_mono.cpp:206-255 rgb.csv loader and per-sequence
calibration.yaml, docs/toy_sequence/calibration.yaml):

    <out>/rgb/<i>.png            grayscale frames
    <out>/rgb.csv                "ts_rgb_0 (ns),path_rgb_0" rows
    <out>/calibration.yaml       cameras: [fx, fy, cx, cy, distortion, fps]
    <out>/groundtruth.csv        TUM-style ts tx ty tz qx qy qz qw (T_wc)

The scene is the test-suite's textured relief plane (tests/synth_scene.py,
numpy only, found beside the package as tools/make_synth_sequence.py
finds it); the trajectory is a circle with a revisit tail so loop closure
fires. Port of tools/make_synth_sequence.py: the same frames, rgb.csv,
groundtruth.csv and calibration.yaml, the frames written as 8-bit gray
PNGs by io/png.write_png (zlib, no PIL). Host numpy only, no device.

    python -m anyfeature_vslam_tpu_torch.tools.make_synth_sequence \
        out_dir:/tmp/seq n_frames:120 width:640 height:480 revisit:0.25 \
        radius:0.8 seed:3 [max_frames:48]

One argument beyond the JAX tool's: ``max_frames:`` writes only the first
frames of the n_frames trajectory (the text files list those frames).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io.png import write_png
from ..run_mono import parse_args

# the repository's tests/ folder, which holds synth_scene.py
TESTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests")


def _synth_scene():
    """tests/synth_scene.py, the renderer (numpy only)."""
    if TESTS_DIR not in sys.path:
        sys.path.insert(0, TESTS_DIR)
    import synth_scene

    return synth_scene


def rotmat_to_quat(r):
    """xyzw quaternion from rotation matrix."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                         (r[1, 0] - r[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(r[i, i] - r[j, j] - r[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (r[j, i] + r[i, j]) / s
    q[k] = (r[k, i] + r[i, k]) / s
    q[3] = (r[k, j] - r[j, k]) / s
    return q


def poses_for(trajectory, n, revisit, radius):
    """The n camera poses (T_cw) of `trajectory` ("circle", the default,
    with a revisit tail; "two_circles", "two_circles_revisit",
    "loop_detour")."""
    look_down_pose = _synth_scene().look_down_pose

    poses = []
    if trajectory == "two_circles":
        # lap around circle A, transit to a disjoint circle B, lap B, then
        # return to A's start: rotation-heavy motion accumulates monocular
        # scale/rotation drift over ~2 laps of fresh territory, so the
        # return to A cannot re-match the live map directly and loop
        # closure must fire (the plain revisit trajectories reconnect via
        # local matching and never need a loop)
        na = int(round(0.40 * n))
        nt1 = int(round(0.08 * n))
        nb = int(round(0.36 * n))
        nt2 = n - na - nt1 - nb
        bx = 2.5 + 3.5 * radius
        for i in range(na):
            ang = 2 * np.pi * i / na
            poses.append(look_down_pose(2.5 + radius * np.cos(ang),
                                        2.5 + radius * np.sin(ang), -2.0))
        for i in range(nt1):
            f = (i + 1) / nt1
            x = (2.5 + radius) * (1 - f) + (bx + radius) * f
            poses.append(look_down_pose(x, 2.5, -2.0))
        for i in range(nb):
            ang = 2 * np.pi * i / nb
            poses.append(look_down_pose(bx + radius * np.cos(ang),
                                        2.5 + radius * np.sin(ang), -2.0))
        for i in range(nt2):
            f = (i + 1) / nt2
            x = (bx + radius) * (1 - f) + (2.5 + radius) * f
            poses.append(look_down_pose(x, 2.5, -2.0))
    elif trajectory == "two_circles_revisit":
        # lap circle A, transit to circle B, lap B, transit back, then a
        # REVISIT LAP around A: unlike two_circles (which ends at A's
        # edge), the revisit lap keeps minting keyframes inside A's old
        # territory for many consecutive events — what the loop-closing
        # consistency chain (3 consecutive keyframes with consistent BoW
        # candidates, reference LoopClosing.cc:46,119-245) needs to fire
        na = int(round(0.30 * n))
        nt1 = int(round(0.07 * n))
        nb = int(round(0.30 * n))
        nt2 = int(round(0.07 * n))
        ne = n - na - nt1 - nb - nt2
        bx = 2.5 + 3.5 * radius
        for i in range(na):
            ang = 2 * np.pi * i / na
            poses.append(look_down_pose(2.5 + radius * np.cos(ang),
                                        2.5 + radius * np.sin(ang), -2.0))
        for i in range(nt1):
            f = (i + 1) / nt1
            x = (2.5 + radius) * (1 - f) + (bx + radius) * f
            poses.append(look_down_pose(x, 2.5, -2.0))
        for i in range(nb):
            ang = 2 * np.pi * i / nb
            # smooth height oscillation on the far circle: monocular SLAM
            # accumulates SCALE drift through depth changes without ever
            # losing track — by the revisit the old map mismatches in
            # scale, guided matching cannot reconnect, and only a
            # free-scale Sim3 loop closure can (the scenario
            # OptimizeEssentialGraph exists for)
            z = -2.0 - 0.5 * np.sin(ang)
            poses.append(look_down_pose(bx + radius * np.cos(ang),
                                        2.5 + radius * np.sin(ang), z))
        for i in range(nt2):
            f = (i + 1) / nt2
            x = (bx + radius) * (1 - f) + (2.5 + radius) * f
            poses.append(look_down_pose(x, 2.5, -2.0))
        for i in range(ne):
            ang = 2 * np.pi * i / na  # same angular rate as the first lap
            poses.append(look_down_pose(2.5 + radius * np.cos(ang),
                                        2.5 + radius * np.sin(ang), -2.0))
    elif trajectory == "loop_detour":
        # circle, then a long detour into fresh territory, then return to
        # the circle start: drift accumulates on the detour while new
        # keyframes are minted continuously, so re-entering the start
        # region triggers genuine loop-closure detection (a plain revisit
        # of a just-tracked circle re-matches the live map directly and
        # never runs detection — no new keyframes are created)
        n_circle = int(round(0.55 * n))
        n_out = int(round(0.225 * n))
        n_back = n - n_circle - n_out
        reach = 2.6 * radius
        for i in range(n_circle):
            ang = 2 * np.pi * i / n_circle
            poses.append(look_down_pose(2.5 + radius * np.cos(ang),
                                        2.5 + radius * np.sin(ang), -2.0))
        x0, y0 = 2.5 + radius, 2.5
        for i in range(n_out):
            f = (i + 1) / n_out
            poses.append(look_down_pose(x0 + reach * f, y0 + 0.6 * radius * np.sin(2.5 * np.pi * f), -2.0))
        for i in range(n_back):
            f = 1.0 - (i + 1) / n_back
            poses.append(look_down_pose(x0 + reach * f, y0 - 0.5 * radius * np.sin(2.5 * np.pi * f), -2.0))
    else:
        n_circle = int(round(n / (1.0 + revisit)))
        for i in range(n):
            ang = 2 * np.pi * (i % n_circle) / n_circle
            poses.append(look_down_pose(2.5 + radius * np.cos(ang),
                                        2.5 + radius * np.sin(ang), -2.0))
    return poses


def write_sequence_files(out, poses, fps, w, h):
    """rgb.csv, groundtruth.csv and calibration.yaml of the frames `poses`
    (frame i at rgb/<i>.png, time i / fps), as the JAX tool writes them."""
    fx = fy = 0.8125 * w  # 260/320 of the test camera, resolution-scaled
    cx, cy = w / 2.0, h / 2.0
    rows = []
    gt = ["# ts tx ty tz qx qy qz qw (T_wc)"]
    for i, t_cw in enumerate(poses):
        ts_ns = int(round(i / fps * 1e9))
        rows.append(f"{ts_ns},rgb/{i:06d}.png")
        t_wc = np.linalg.inv(np.asarray(t_cw, np.float64))
        q = rotmat_to_quat(t_wc[:3, :3])
        gt.append(
            f"{i / fps:.6f} "
            + " ".join(f"{v:.8f}" for v in t_wc[:3, 3])
            + " " + " ".join(f"{v:.8f}" for v in q)
        )
    with open(os.path.join(out, "rgb.csv"), "w") as f:
        f.write("ts_rgb_0 (ns),path_rgb_0\n" + "\n".join(rows) + "\n")
    with open(os.path.join(out, "groundtruth.csv"), "w") as f:
        f.write("\n".join(gt) + "\n")
    with open(os.path.join(out, "calibration.yaml"), "w") as f:
        f.write(
            "%YAML:1.0\n\n"
            f"Camera.fx: {fx}\nCamera.fy: {fy}\n"
            f"Camera.cx: {cx}\nCamera.cy: {cy}\n\n"
            "Camera.k1: 0.0\nCamera.k2: 0.0\n"
            "Camera.p1: 0.0\nCamera.p2: 0.0\nCamera.k3: 0.0\n\n"
            f"Camera.w: {w}\nCamera.h: {h}\n\n"
            f"Camera.fps: {fps}\n"
        )


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    out = args.get("out_dir")
    if not out:
        print(__doc__)
        return 1
    n = int(args.get("n_frames", 120))
    w = int(args.get("width", 640))
    h = int(args.get("height", 480))
    fps = float(args.get("fps", 30.0))
    revisit = float(args.get("revisit", 0.25))
    radius = float(args.get("radius", 0.8))
    seed = int(args.get("seed", 3))
    # per-frame Gaussian image noise (gray levels): degrades feature
    # localization so monocular drift accumulates realistically — the
    # noise-free renderer tracks so cleanly that revisits reconnect
    # without ever needing a loop closure
    noise = float(args.get("noise", 0.0))

    synth_scene = _synth_scene()
    fx = fy = 0.8125 * w  # 260/320 of the test camera, resolution-scaled
    k = np.array([[fx, 0, w / 2.0], [0, fy, h / 2.0], [0, 0, 1]], np.float64)
    tex = synth_scene.make_texture(n_blobs=15000, seed=seed,
                                   distinct=args.get("texture", "") == "distinct")
    scene = synth_scene.PlaneScene(k, w, h, seed=seed, tex=tex)
    poses = poses_for(args.get("trajectory", "circle"), n, revisit, radius)
    poses = poses[:min(n, int(args.get("max_frames", n)))]

    os.makedirs(os.path.join(out, "rgb"), exist_ok=True)
    for i, t_cw in enumerate(poses):
        img = scene.render(t_cw)
        if noise > 0:
            nrng = np.random.default_rng(seed * 100003 + i)
            img = img + nrng.normal(0.0, noise, img.shape)
        write_png(os.path.join(out, f"rgb/{i:06d}.png"), np.clip(img, 0, 255).astype(np.uint8))
        if (i + 1) % 20 == 0:
            print(f"rendered {i + 1}/{n}", flush=True)
    write_sequence_files(out, poses, fps, w, h)
    print(f"wrote {len(poses)} frames to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
