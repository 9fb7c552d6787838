"""Loop closing of the PyTorch port against the JAX package on the
constructed loop map of tests/test_loop_closing_unit.py (tests/loop_map.py
builds it in numpy for both), and the two-session live closure on the port
alone (slow).

Tolerances and why:
- the same keyframe closes the loop with the same candidate, and the same
  loop edge is recorded: detection is integer bookkeeping on equal words,
  and the Sim3 gates are counts far from their thresholds;
- keyframe poses within 2e-3 after the correction, the fusion and the
  essential graph, where the global BA starts (float32 Sim3 and pose-graph
  LMs summed in another order; 3e-6 measured), and within 2e-2 after the
  global BA: on this map the BA's 5 + 10 steps end in a flat valley, where
  a 1e-6 move of one point's input moves the port's own result by 5e-3
  and 30 more steps move it by 4e-2 (measured on the CPU), so no float
  implementation agrees closer there;
- the end drift below 0.6 of its value before the closure, the JAX test's
  bound;
- the _compute_sim3 gate (>= 40 matched points, reference
  LoopClosing.cc:365-401) gives the same verdict for 28 and 70 shared
  points, with the Sim3 within 1e-4 when it passes.
"""

import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anyfeature_vslam_tpu.ops.camera import CameraParams
from anyfeature_vslam_tpu.place_recognition import vocab as jvoc
from anyfeature_vslam_tpu.place_recognition.database import KeyFrameDatabase as JaxDb
from anyfeature_vslam_tpu.slam.loop_closing import LoopCloser as JaxCloser
from anyfeature_vslam_tpu.slam.map_state import SlamMap as JaxMap
from anyfeature_vslam_tpu_torch.place_recognition import vocab as tvoc
from anyfeature_vslam_tpu_torch.place_recognition.database import KeyFrameDatabase as PortDb
from anyfeature_vslam_tpu_torch.slam.loop_closing import LoopCloser as PortCloser
from anyfeature_vslam_tpu_torch.slam.map_state import SlamMap as PortMap
from loop_map import CAMERA, build_loop_map, end_drift, train_map_vocabulary

PortMapCpu = functools.partial(PortMap, device="cpu")


def _closers(jm, tm):
    jv = train_map_vocabulary(jm, jvoc.train_vocabulary)
    tv = tvoc.Vocabulary(jv.branching, jv.depth, jv.centroids, jv.idf)
    jc = JaxCloser(jm, CameraParams.create(**CAMERA), JaxDb(jv, jm.max_kf), match_th=75.0)
    tc = PortCloser(tm, SimpleNamespace(**CAMERA), PortDb(tv, tm.max_kf, "cpu"), match_th=75.0,
                    device="cpu")
    return jc, tc


def _closing_keyframe(closer, m, n_kf):
    for kf in range(n_kf):
        if closer.process_keyframe(kf):
            return kf
    return None


def _snapshot_ba_input(monkeypatch, module, store):
    """Keep the keyframe poses the JAX package's global BA starts from (the
    port's LoopCloser logs them in gba_log)."""
    run = module.run_bundle_adjustment

    def wrapped(m, *a, **kw):
        store.append(m.kf_pose.copy())
        return run(m, *a, **kw)

    monkeypatch.setattr(module, "run_bundle_adjustment", wrapped)


def test_loop_closure_matches_jax(monkeypatch):
    from anyfeature_vslam_tpu.slam import loop_closing as jlc

    jm, gt_pose = build_loop_map(JaxMap)
    tm, _ = build_loop_map(PortMapCpu)
    n_kf = jm.n_keyframes()
    jc, tc = _closers(jm, tm)
    before = end_drift(tm, gt_pose, n_kf)
    ba_in_j = []
    _snapshot_ba_input(monkeypatch, jlc, ba_in_j)
    kf_j = _closing_keyframe(jc, jm, n_kf)
    kf_t = _closing_keyframe(tc, tm, n_kf)
    assert kf_j is not None and kf_t == kf_j
    assert tm.loop_edges == jm.loop_edges and len(tm.loop_edges) == 1
    assert tc.n_loops_closed == jc.n_loops_closed == 1
    assert tm.change_idx == 1
    assert np.array_equal(tm.kf_matches, jm.kf_matches)  # the same fusion
    assert len(tc.gba_log) == len(ba_in_j) == 1
    for k in tm.keyframe_ids():
        np.testing.assert_allclose(tc.gba_log[0]["kf_pose_in"][k], ba_in_j[0][k], atol=2e-3, rtol=0,
                                   err_msg=f"keyframe {k} before the global BA")
        np.testing.assert_allclose(tm.kf_pose[k], jm.kf_pose[k], atol=2e-2, rtol=0,
                                   err_msg=f"keyframe {k}")
    assert end_drift(jm, gt_pose, n_kf) < 0.6 * before
    assert end_drift(tm, gt_pose, n_kf) < 0.6 * before
    # the stages ran and the global BA is logged with its caps and solver
    for stage in ("bow", "detect", "sim3", "correct", "fuse", "essential_graph", "global_ba"):
        assert tc.stage_times.get(stage), stage
    gba = tc.gba_log[0]
    assert gba["n_kf"] == n_kf and gba["dense"] and gba["k_cap"] == 64


def _two_kf_shared_map(map_cls, n_shared, seed=7):
    """tests/test_loop_closing_unit.py:_two_kf_shared_map for either
    package's SlamMap: the current keyframe (slot 2) re-observes n_shared
    of candidate keyframe 0's points; keyframe 1 is its covisible
    neighbour."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = CAMERA["fx"], CAMERA["fy"], CAMERA["cx"], CAMERA["cy"]
    n_feat = 256
    m = map_cls(max_kf=8, max_pt=2000, n_feat=n_feat)
    poses = [np.eye(4, dtype=np.float32) for _ in range(3)]
    poses[1][:3, 3] = [0.15, 0.0, 0.0]
    poses[2][:3, 3] = [0.0, 0.12, 0.05]
    uv0 = rng.uniform([20, 20], [300, 220], (n_shared, 2))
    z = rng.uniform(3.0, 6.0, n_shared)
    pw = np.stack([(uv0[:, 0] - cx) / fx * z, (uv0[:, 1] - cy) / fy * z, z], -1)
    descs = rng.integers(0, 2, (n_shared, 256)).astype(np.uint8)
    ids = m.add_points(pw.astype(np.float32), descs, ref_kf=0,
                       ref_sizes=np.ones(n_shared, np.float32))
    for t_cw in poses:
        feats = dict(uv_und=np.zeros((n_feat, 2), np.float32),
                     desc_bits=np.zeros((n_feat, 256), np.uint8),
                     octave=np.zeros(n_feat, np.int32), size=np.ones(n_feat, np.float32),
                     angle=np.zeros(n_feat, np.float32), inv_sigma2=np.ones(n_feat, np.float32),
                     valid=np.zeros(n_feat, bool))
        matches = np.full(n_feat, -1, np.int32)
        pc = pw @ t_cw[:3, :3].T + t_cw[:3, 3]
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
        ok = (pc[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < 320) & (uv[:, 1] > 0) \
            & (uv[:, 1] < 240)
        for slot, i in enumerate(np.nonzero(ok)[0]):
            feats["uv_und"][slot] = uv[i]
            feats["desc_bits"][slot] = descs[i]
            feats["valid"][slot] = True
            matches[slot] = ids[i]
        cur = m.add_keyframe(t_cw, ts=0.0, frame_id=0, feats=feats, matches=matches)
    m.update_point_stats()
    return m, cur


@pytest.mark.parametrize("n_shared,expect", [(28, False), (70, True)])
def test_compute_sim3_gate_matches_jax(n_shared, expect):
    jm, cur = _two_kf_shared_map(JaxMap, n_shared)
    tm, _ = _two_kf_shared_map(PortMapCpu, n_shared)
    jv = jvoc.train_vocabulary(np.concatenate([jm.kf_desc_bits[k][jm.kf_feat_valid[k]]
                                               for k in jm.keyframe_ids()]),
                               branching=8, depth=2, iters=3)
    tv = tvoc.Vocabulary(jv.branching, jv.depth, jv.centroids, jv.idf)
    jc = JaxCloser(jm, CameraParams.create(**CAMERA), JaxDb(jv, jm.max_kf), match_th=75.0)
    tc = PortCloser(tm, SimpleNamespace(**CAMERA), PortDb(tv, tm.max_kf, "cpu"), match_th=75.0,
                    device="cpu")
    okj, rj, tj, sj = jc._compute_sim3(cur, 0)
    okt, rt, tt, st = tc._compute_sim3(cur, 0)
    assert okt == okj == expect
    if expect:
        np.testing.assert_allclose(rt, np.asarray(rj), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tt, np.asarray(tj), atol=1e-4, rtol=0)
        assert abs(st - sj) < 1e-4
        assert np.array_equal(tc._pending_merge[0], jc._pending_merge[0])
        assert np.array_equal(tc._pending_merge[1], jc._pending_merge[1])


@pytest.mark.slow
def test_live_two_session_closure_on_the_port(tmp_path):
    """tests/test_loop_live.py on the port: session A maps circle A and
    saves a checkpoint; session B loads it, boots a fresh component and
    re-enters A's territory; the loop closes with the test's bounds. The
    test's evaluate() pairs keyframes with ground truth by timestamp, so it
    scores session A's keyframes only (session B's carry +100 s); the
    keyframe ATE over both sessions, which only a right closure keeps low,
    is held to the same 8 cm."""
    import subprocess
    import sys

    from anyfeature_vslam_tpu_torch.io import dataset, evaluation
    from anyfeature_vslam_tpu_torch.system import System

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    n = 360
    seq_dir = str(tmp_path / "seq")
    r = subprocess.run([sys.executable, os.path.join(root, "tools", "make_synth_sequence.py"),
                        f"out_dir:{seq_dir}", f"n_frames:{n}", "width:320", "height:240",
                        "trajectory:two_circles_revisit", "seed:3", "texture:distinct"],
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr
    seq = dataset.load_sequence(seq_dir)
    na, nt1 = int(round(0.30 * n)), int(round(0.07 * n))
    sys_a = System(seq.camera, fps=seq.fps, n_features=600, device="cpu")
    for i in range(na):
        sys_a.track_monocular(dataset.load_gray(seq.image_paths[i]), seq.timestamps[i])
    assert sys_a.tracker.stats["resets"] == 0
    ckpt = str(tmp_path / "a.npz")
    sys_a.save_checkpoint(ckpt)
    sys_b = System(seq.camera, fps=seq.fps, n_features=600, device="cpu")
    sys_b.load_checkpoint(ckpt)
    assert sys_b.map.n_keyframes() >= 10
    for i in range(na + nt1, n):
        sys_b.track_monocular(dataset.load_gray(seq.image_paths[i]), seq.timestamps[i] + 100.0)
    st = sys_b.tracker.stats
    assert st["resets"] == 0 and st["lost_frames"] <= 5, st
    assert sys_b.loop_closer.n_loops_closed >= 1 and len(sys_b.map.loop_edges) >= 1
    out = str(tmp_path / "out")
    sys_b.save_outputs(out, "m")
    kf = evaluation.evaluate(os.path.join(out, "m_KeyFrameTrajectory.csv"),
                             os.path.join(seq_dir, "groundtruth.csv"))
    assert kf["n_pairs"] >= 8 and kf["ate_rmse"] < 0.08, kf
    ts, xyz = evaluation.load_vslamlab_csv(os.path.join(out, "m_KeyFrameTrajectory.csv"))
    ts_g, xyz_g = evaluation.load_tum(os.path.join(seq_dir, "groundtruth.csv"))
    ia, ib = evaluation.associate(np.where(ts >= 100.0, ts - 100.0, ts), ts_g)
    both = evaluation.ate_rmse(xyz[ia], xyz_g[ib])[0]
    assert len(ia) == len(ts) and (ts >= 100.0).sum() >= 8 and both < 0.08, both
