"""Keyframe ATE of a System on the bench sequence, for chip_smoke.py
phase 13's per-family ATE gate: the JAX package's System (on the CPU) or
the port's (on the CPU or the card).

    JAX_PLATFORMS=cpu python tests/family_ate.py jax brisk48 [n_frames]
    python tests/family_ate.py port anyfeat_bin [n_frames] [device]

Runs the System with its defaults (asynchronous mapping, the shipped
vocabulary, loop detection at every event) over the first n_frames
(default 48) of tests/torch_slice_scene.py's bench sequence at 640x480
with 1000 features, printing per frame the state, keyframes, points,
inliers, the Sim3-aligned keyframe ATE and the last keyframe's camera
centre (map units), then the tracker's stats. The
port runs on `device` (default cpu).
"""

import os
import sys
import time

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]


def main(package: str, feature: str, n_frames: int = 48, device: str = "cpu"):
    import numpy as np

    from torch_slice_scene import SliceScene

    sc = SliceScene(640, 480)
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from anyfeature_vslam_tpu.io import evaluation
        from anyfeature_vslam_tpu.ops.camera import CameraParams
        from anyfeature_vslam_tpu.system import System

        system = System(CameraParams.create(**sc.camera), feature=feature, n_features=1000,
                        use_mesh=False)
    else:
        from types import SimpleNamespace

        from anyfeature_vslam_tpu_torch.io import evaluation
        from anyfeature_vslam_tpu_torch.system import System

        system = System(SimpleNamespace(**sc.camera), feature=feature, n_features=1000,
                        device=device)

    def centre(t):
        return -t[:3, :3].T @ t[:3, 3]

    t0 = time.perf_counter()
    for i in range(n_frames):
        state = system.track_monocular(sc.render(i)[0], i / 30.0)
        m = system.map
        kfs = m.keyframe_ids()
        ate = evaluation.ate_rmse(
            np.array([centre(m.kf_pose[k].astype(np.float64)) for k in kfs]),
            np.array([centre(sc.poses[int(m.kf_frame_id[k])]) for k in kfs]))[0] \
            if len(kfs) >= 3 else float("nan")
        last = np.round(centre(m.kf_pose[kfs[-1]].astype(np.float64)), 5) if len(kfs) else None
        print(f"{i} {state.name} keyframes {m.n_keyframes()} points {m.n_points()} inliers "
              f"{system.tracker.n_inliers} keyframe ATE {ate:.5f} m, last keyframe's centre "
              f"{last} {time.perf_counter() - t0:.1f} s", flush=True)
    system.shutdown()
    print(f"{package} {feature}: {dict(system.tracker.stats)}, keyframe ATE {ate:.5f} m",
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], *(int(a) for a in sys.argv[3:4]), *sys.argv[4:5])
