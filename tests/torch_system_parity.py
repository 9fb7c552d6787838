"""The synchronous System of both packages over the first frames of the
rendered benchmark scene at 320x240 with 600 features, and the checks
the per-family parity tests (tests/test_torch_system_<family>.py) make.

The runs are not in lockstep: the keyframe decision compares tracked
inliers with a 0.9 fraction of the reference keyframe's points, float32
BA ends a few millimetres from JAX's (other summation orders; ROADMAP.md
section 3), and the ring and learned48 descriptors differ from JAX's in a
few rows (tests/test_torch_families.py). A decision a few inliers from
its threshold flips within the first frames, and from then on the maps
differ in which frames are keyframes. Both runs hold every BLAS and
OpenMP pool that threadpoolctl finds to one thread, and torch's intra-op
pool too; the JAX run still depends on the thread count its process
started with (anyfeat_nonbin: keyframe ATE 0.47 cm with OMP_NUM_THREADS=2,
2.34 cm without it; the port's run is the same under both), which a test
cannot set once JAX is imported. Measured so (without OMP_NUM_THREADS,
as the tier-1 command runs): keyframe counts 0 / 9.1 / 12.5% apart
(brisk48 / anyfeat_bin / anyfeat_nonbin), point counts 15.8 / 9.3 / 4.4%,
raw keyframe centres up to 2.0e-2 / 1.3e-2 / 3.2e-2 apart from frame 2
on, 1.1e-2 / 9.8e-3 / 3.0e-2 after a Sim3 alignment. So the checks are,
with their tolerances:
- the same initialization frame, and initial map points within 1% (the
  same matches and RANSAC draws, bar a descriptor row);
- the two keyframes of the initialization, made before any decision can
  differ: centres within 1e-2 map units (the map's scale is the initial
  median depth, about 2 m; measured up to 5e-3);
- at the last frame, keyframe and point counts within 25%;
- >= 60% of the JAX run's keyframes minted at the same frames in the
  port, their centres within 4e-2 of JAX's after a Sim3 alignment of the
  two maps (measured up to 3.0e-2, where JAX's run is 2.34 cm from the
  truth); the port's keyframe trajectory within 1.5 cm of ground truth
  after Sim3 alignment (measured up to 0.91 cm) and JAX's within 3 cm.
"""

import numpy as np
import torch

from torch_slice_scene import SliceScene

W, H, N_FEATURES = 320, 240, 600
N_PARITY = 12


def _run(system, frames):
    rows = []
    for i, img in enumerate(frames):
        state = system.track_monocular(img, i / 30.0)
        rows.append((state.name, system.map.n_keyframes(), system.map.n_points()))
    m = system.map
    poses = {int(m.kf_frame_id[k]): m.kf_pose[k].copy() for k in m.keyframe_ids()}
    return rows, poses, dict(system.tracker.stats), m.kf_desc_bits.dtype


def runs(feature):
    """(JAX run, port run) of `feature`, synchronous mapping, no loop
    closing: each (per-frame (state, keyframes, points), keyframe poses by
    frame, tracker stats, the map's descriptor dtype)."""
    from anyfeature_vslam_tpu.ops.camera import CameraParams as JaxCamera
    from anyfeature_vslam_tpu.system import System as JaxSystem
    from anyfeature_vslam_tpu_torch.system import System

    sc = SliceScene(W, H)
    frames = [sc.render(i)[0] for i in range(N_PARITY)]
    jsys = JaxSystem(JaxCamera.create(**sc.camera), feature=feature, n_features=N_FEATURES,
                     enable_loop_closing=False, async_mapping=False, use_mesh=False)
    tsys = System(JaxCamera.create(**sc.camera), feature=feature, n_features=N_FEATURES,
                  enable_loop_closing=False, async_mapping=False, device="cpu")
    # one thread for every BLAS and OpenMP pool (numpy's host linear
    # algebra in both packages, torch's intra-op pool): the JAX run's
    # host-side sums otherwise depend on the thread count
    from threadpoolctl import threadpool_limits

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            return _run(jsys, frames), _run(tsys, frames)
    finally:
        torch.set_num_threads(n_threads)


def _init(rows):
    i = next(k for k, r in enumerate(rows) if r[0] == "OK")
    return i, rows[i][2]


def _centre(t):
    t = t.astype(np.float64)
    return -t[:3, :3].T @ t[:3, 3]


def check_same_initialization(runs):
    (jrows, jposes, _, jdt), (trows, tposes, _, tdt) = runs
    assert tdt == jdt
    (ji, jn), (ti, tn) = _init(jrows), _init(trows)
    assert ti == ji and abs(tn - jn) <= 0.01 * jn and jn > 100, ((ti, tn), (ji, jn))
    init_pair = [f for f in sorted(set(jposes) & set(tposes)) if f <= ji]
    assert len(init_pair) == 2, (sorted(jposes), sorted(tposes))
    for fid in init_pair:
        d = np.linalg.norm(_centre(tposes[fid]) - _centre(jposes[fid]))
        assert d < 1e-2, (fid, d)


def check_map_counts(runs):
    (jrows, _, jstats, _), (trows, _, tstats, _) = runs
    for k in (1, 2):
        assert abs(trows[-1][k] - jrows[-1][k]) <= 0.25 * jrows[-1][k], (trows[-1], jrows[-1])
    assert tstats["resets"] == jstats["resets"] == 0
    assert tstats["tracked_frames"] >= N_PARITY - 2


def check_keyframe_trajectories(runs):
    from anyfeature_vslam_tpu_torch.io import evaluation

    (_, jposes, _, _), (_, tposes, _, _) = runs
    common = sorted(set(jposes) & set(tposes))
    assert len(common) >= 0.6 * len(jposes), (sorted(jposes), sorted(tposes))
    a = np.stack([_centre(tposes[f]) for f in common])
    b = np.stack([_centre(jposes[f]) for f in common])
    _, (s, r, t) = evaluation.ate_rmse(a, b)
    d = np.linalg.norm(s * a @ r.T + t - b, axis=1)
    assert d.max() < 4e-2, dict(zip(common, d))
    sc = SliceScene(W, H)
    for poses, bound in ((tposes, 0.015), (jposes, 0.03)):
        est = np.stack([_centre(p) for p in poses.values()])
        gt = np.stack([_centre(sc.poses[f]) for f in poses])
        assert evaluation.ate_rmse(est, gt)[0] < bound
