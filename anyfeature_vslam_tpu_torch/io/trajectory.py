"""Trajectory / statistics writers matching the reference output formats
(port of anyfeature_vslam_tpu/io/trajectory.py).

- Keyframe trajectory CSV (reference System::SaveKeyFrameTrajectoryVSLAMLAB,
  src/System.cc:415-459): header ``ts (ns),tx (m),ty (m),tz (m),qx,qy,qz,qw``,
  camera CENTER t = -R^T t_cw and world rotation q = quat(R_cw^T).
- Frame trajectory TUM format (reference SaveTrajectoryTUM,
  src/System.cc:353-412): per tracked frame, pose recovered as
  T_cur_ref * T_ref_world at save time so post-hoc keyframe optimization
  propagates to all frames.
- Statistics yaml (reference SaveStatistics, src/System.cc:535-606).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import se3 as se3_ops


def _pose_to_center_quat(t_cw: np.ndarray):
    r = np.asarray(t_cw[:3, :3], np.float32)
    center = -r.T @ t_cw[:3, 3]
    q = se3_ops.rot_to_quat(torch.from_numpy(r.T.copy())).numpy()
    return center, q


def save_keyframe_trajectory_vslamlab(path, slam_map):
    kf_ids = slam_map.keyframe_ids()
    order = np.argsort(slam_map.kf_frame_id[kf_ids], kind="stable")
    with open(path, "w") as f:
        f.write("ts (ns),tx (m),ty (m),tz (m),qx,qy,qz,qw\n")
        for kf in kf_ids[order]:
            c, q = _pose_to_center_quat(slam_map.kf_pose[kf])
            ts_ns = int(round(slam_map.kf_ts[kf] * 1e9))
            f.write(
                f"{ts_ns},{c[0]:.7e},{c[1]:.7e},{c[2]:.7e},"
                f"{q[0]:.7e},{q[1]:.7e},{q[2]:.7e},{q[3]:.7e}\n"
            )


def save_frame_trajectory_tum(path, trajectory, slam_map):
    """trajectory: list of (ts, T_cur_ref, ref_kf_uid, lost). Culled
    reference keyframes are resolved through the retired-anchor chain."""
    with open(path, "w") as f:
        for ts, t_cr, ref_uid, lost in trajectory:
            if lost:
                continue
            t_cw = slam_map.resolve_anchor(t_cr, ref_uid)
            if t_cw is None:
                continue
            c, q = _pose_to_center_quat(t_cw)
            f.write(
                f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_frame_trajectory_kitti(path, trajectory, slam_map):
    """KITTI format (reference SaveTrajectoryKITTI, src/System.cc:461-515):
    one line per tracked frame, row-major 3x4 [R_wc | t_wc], relative to
    the first keyframe."""
    kf_ids = slam_map.keyframe_ids()
    if len(kf_ids) == 0:
        open(path, "w").close()
        return
    first = kf_ids[np.argmin(slam_map.kf_frame_id[kf_ids])]
    t_wo = np.linalg.inv(slam_map.kf_pose[first])
    with open(path, "w") as f:
        for ts, t_cr, ref_uid, lost in trajectory:
            if lost:
                continue
            t_cw_abs = slam_map.resolve_anchor(t_cr, ref_uid)
            if t_cw_abs is None:
                continue
            t_cw = t_cw_abs @ t_wo
            r_wc = t_cw[:3, :3].T
            t_wc = -r_wc @ t_cw[:3, 3]
            vals = np.hstack([r_wc, t_wc[:, None]]).reshape(-1)
            f.write(" ".join(f"{v:.9f}" for v in vals) + "\n")


def save_statistics_yaml(path, slam_map, stats: dict):
    counts = slam_map.point_observation_counts()
    n_pts = slam_map.n_points()
    n_obs = int(counts.sum())
    lines = [
        "# anyfeature_vslam_tpu run statistics",
        f"numKeyframes: {slam_map.n_keyframes()}",
        f"numPoints: {n_pts}",
        f"numObservations: {n_obs}",
        f"obsPerPoint: {n_obs / max(n_pts, 1):.3f}",
    ]
    for k, v in stats.items():
        lines.append(f"{k}: {v}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
