"""The plane scene of tests/test_rgbd_stereo.py for the port's RGB-D and
stereo checks (tests/test_torch_rgbd.py, tests/test_torch_stereo.py and
chip_smoke.py's phases 15 and 16): its texture, poses and 0.1 m baseline,
at any image size, the intrinsics scaled from 320x240 (fx 260, the
principal point at the centre). numpy only.
"""

import numpy as np

from synth_scene import PlaneScene, look_down_pose, make_texture

BASELINE = 0.1  # metres between the rectified cameras


def plane_intrinsics(width, height):
    """(fx, cx, cy) at width x height: fx 260 at 320 wide."""
    return 260.0 * width / 320.0, width / 2.0, height / 2.0


def plane_scene(width, height):
    fx, cx, cy = plane_intrinsics(width, height)
    k = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], np.float64)
    return PlaneScene(k, width, height, seed=5, tex=make_texture(n_blobs=15000, seed=5))


def line_traj(n, x0=2.0, x1=3.0, y=2.5, z=-2.0):
    """n poses 2 m above the plane, moving along x from x0 to x1."""
    return [look_down_pose(x0 + (x1 - x0) * i / (n - 1), y, z) for i in range(n)]


def out_and_back(x0, y=2.5, z=-2.0):
    """Poses from x0 out 3.24 m along x, beyond the mapped area (no map
    point stays in view there), and 1.68 m back, the speed ramped in
    0.03 m steps so the constant-velocity prediction stays within the
    motion model's search radius; it ends at rest."""
    steps = ([0.0, 0.03, 0.06, 0.09] + [0.12] * 24 + [0.09, 0.06, 0.03, 0.0, -0.03, -0.06, -0.09]
             + [-0.12] * 11 + [-0.09, -0.06, -0.03, 0.0])
    return [look_down_pose(x, y, z) for x in x0 + np.cumsum(steps)]


def right_view(scene, t_cw):
    """The rectified right image: the camera shifted by BASELINE along its
    x."""
    t_shift = np.eye(4)
    t_shift[0, 3] = -BASELINE
    return scene.render(t_shift @ np.asarray(t_cw, np.float64))
