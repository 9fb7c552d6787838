"""Pose LM, the fused tracked-frame step and the slice of the PyTorch port
against the JAX package, on the rendered benchmark scene at 320x240 with a
ground-truth map (tests/torch_slice_scene.py).

Tolerances and why:
- pose_optimize: rotation and translation within 1e-4, inlier masks
  >= 99.5% equal: the same LM in float32 with other summation orders;
- fused_track_step on JAX's own features and the same state: final point
  ids >= 99% equal, inliers within 1%, pose within 1e-3 (the LM rounds
  can move a borderline observation across the chi2 gate);
- the slice (extraction included) over 4 tracked frames: inliers within
  5% and pose within 5e-3 rad / 5e-3 m of JAX, both within 2 cm of ground
  truth, since the fp32 pyramid moves a few keypoints (test_torch_frontend).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu import flagship as jflag
from anyfeature_vslam_tpu.frontend import extractor as jext
from anyfeature_vslam_tpu.ops import camera as jcam
from anyfeature_vslam_tpu.ops import pose_opt as jpose
from anyfeature_vslam_tpu.ops import se3 as jse3
from anyfeature_vslam_tpu.slam import fast_track as jtrack
from anyfeature_vslam_tpu_torch import convert, flagship as tflag
from anyfeature_vslam_tpu_torch.frontend import cuda_fast
from anyfeature_vslam_tpu_torch.frontend.extractor import ExtractorConfig, OrbExtractor
from anyfeature_vslam_tpu_torch.ops import cuda_match
from anyfeature_vslam_tpu_torch.ops import pose_opt as tpose
from anyfeature_vslam_tpu_torch.slam import fast_track as ttrack
from torch_slice_scene import (BLOCK_ROWS, FIRST_TRACKED, TRACK_PARAMS, SliceScene,
                               pose_error)

H, W, N_FEATURES = 240, 320, 500
CARRY = ("uv", "bits", "size", "angle", "match_pt", "match_pos")
N_SLICE = 4


def _rot_trans_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    r = a[:3, :3] @ b[:3, :3].T
    w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return np.arctan2(0.5 * np.linalg.norm(w), 0.5 * (np.trace(r) - 1)), np.abs(a[:3, 3] - b[:3, 3]).max()


# ---------------------------------------------------------------- pose LM

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0


def _pose_problem(seed, outlier_frac, noise):
    rng = np.random.default_rng(seed)
    n = 300
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3)).astype(np.float32)
    t_true = np.asarray(jse3.se3_exp(jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.03, 0.01], jnp.float32)))
    p = pts @ t_true[:3, :3].T + t_true[:3, 3]
    uv = np.stack([FX * p[:, 0] / p[:, 2] + CX, FY * p[:, 1] / p[:, 2] + CY], -1)
    uv += rng.normal(0, noise, uv.shape)
    n_out = int(n * outlier_frac)
    uv[:n_out] += rng.uniform(20, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    pert = np.asarray(jse3.se3_exp(jnp.asarray([0.03, -0.02, 0.03, 0.008, -0.01, 0.012], jnp.float32)))
    inv_s2 = (1.0 / rng.choice([1.0, 1.44, 2.07], n) ** 2).astype(np.float32)
    valid = rng.random(n) < 0.95
    return (pert @ t_true).astype(np.float32), pts, uv.astype(np.float32), inv_s2, valid


@pytest.mark.parametrize("seed,outlier_frac,noise", [(0, 0.0, 0.0), (1, 0.25, 0.3), (2, 0.1, 1.0)])
def test_pose_optimize_matches_jax(seed, outlier_frac, noise):
    args = _pose_problem(seed, outlier_frac, noise)
    jp, ji, jn = jpose.pose_optimize(*map(jnp.asarray, args), FX, FY, CX, CY)
    tp, ti, tn = tpose.pose_optimize(*map(torch.from_numpy, args), FX, FY, CX, CY)
    rot, trans = _rot_trans_diff(tp.numpy(), jp)
    assert rot < 1e-4 and trans < 1e-4, (rot, trans)
    assert np.mean(ti.numpy() == np.asarray(ji)) >= 0.995
    assert abs(int(tn) - int(jn)) <= 0.005 * len(ti)


# ----------------------------------------------------- the tracked frame

@pytest.fixture(scope="module")
def slice_case():
    """Scene, JAX-extracted ground-truth map state (numpy) and the JAX
    features of the first tracked frame."""
    sc = SliceScene(W, H)
    cfg = jext.ExtractorConfig(n_features=N_FEATURES)
    jc = jcam.CameraParams.create(**sc.camera)

    def extract(img8):
        f = dict(jext.extract_features(jnp.asarray(img8, jnp.float32), cfg, H, W))
        f["uv_und"] = jcam.undistort_points(jc, f["xy"])
        return {k: np.asarray(v) for k, v in f.items()}

    carry, ref, block = sc.build_state(extract)
    assert block["blk_ids"].shape[0] == BLOCK_ROWS and block["blk_valid"].sum() > 1500
    frames = [sc.render(FIRST_TRACKED + k)[0] for k in range(N_SLICE)]
    return dict(sc=sc, cfg=cfg, jc=jc, carry=carry, ref=ref, block=block, frames=frames,
                feats13=extract(frames[0]))


def _jax_state(case):
    c = [jnp.asarray(case["carry"][k]) for k in CARRY]
    r = [jnp.asarray(v) for v in case["ref"].values()]
    b = [jnp.asarray(v) for v in case["block"].values()]
    return c + r + b


def _tail(sc, pred, last):
    """Arguments after the state, positional as the JAX function takes them."""
    lo, hi = sc.bounds
    p = TRACK_PARAMS
    return [pred, last, True, lo, hi, float(sc.fx), float(sc.fy), float(sc.cx), float(sc.cy),
            p["motion_radius"], p["match_th"], p["min_motion_matches"], p["refkf_ratio"],
            p["local_radius"], p["local_ratio"], p["min_track_inliers"]]


def _torch_tail(sc, pred, last):
    lo, hi = (torch.from_numpy(b) for b in sc.bounds)
    return dict(pred_pose=pred, last_pose=last, use_motion=True, bounds_lo=lo, bounds_hi=hi,
                fx=sc.fx, fy=sc.fy, cx=sc.cx, cy=sc.cy, **TRACK_PARAMS)


def test_fused_track_step_on_jax_features(slice_case):
    sc, f = slice_case["sc"], slice_case["feats13"]
    last = sc.poses[FIRST_TRACKED - 1]
    pred = np.asarray(jtrack.predict_pose(jnp.asarray(last), jnp.asarray(sc.poses[FIRST_TRACKED - 2])))
    cur = [f[k] for k in ("uv_und", "desc_bits", "size", "angle", "valid", "inv_sigma2")]
    tail = _tail(sc, pred, last)
    want = jtrack.fused_track_step(*map(jnp.asarray, cur), *_jax_state(slice_case),
                                   *[jnp.asarray(t) if isinstance(t, np.ndarray) else t for t in tail])
    state = convert.track_state_from_numpy(slice_case["carry"], slice_case["ref"],
                                           slice_case["block"], "cpu")
    got = ttrack.fused_track_step(*map(torch.from_numpy, cur), **state,
                                  **_torch_tail(sc, torch.from_numpy(pred), torch.from_numpy(last)))
    pose, pt, n_in, vis, ok, used_mm, pos = got
    jpose_, jpt, jn, jvis, jok, jused, jpos = want
    assert bool(ok) and bool(jok) and bool(used_mm) == bool(jused)
    assert np.mean(pt.numpy() == np.asarray(jpt)) >= 0.99
    assert abs(int(n_in) - int(jn)) <= 0.01 * int(jn)
    assert np.abs(pose.numpy() - np.asarray(jpose_)).max() < 1e-3
    assert np.mean(vis.numpy() == np.asarray(jvis)) >= 0.99
    assert pos.shape == (N_FEATURES, 3) and vis.shape == (BLOCK_ROWS,)


def test_slice_tracks_like_jax(slice_case):
    sc = slice_case["sc"]
    ext = OrbExtractor(ExtractorConfig(n_features=N_FEATURES), H, W)
    cam = convert.camera_from_numpy(slice_case["jc"], "cpu")
    state = convert.track_state_from_numpy(slice_case["carry"], slice_case["ref"],
                                           slice_case["block"], "cpu")
    jstate = _jax_state(slice_case)
    last_t = torch.from_numpy(sc.poses[FIRST_TRACKED - 1])
    prev_t = torch.from_numpy(sc.poses[FIRST_TRACKED - 2])
    last_j, prev_j = jnp.asarray(last_t.numpy()), jnp.asarray(prev_t.numpy())
    for k, img8 in enumerate(slice_case["frames"]):
        fid = FIRST_TRACKED + k
        pred_j = jtrack.predict_pose(last_j, prev_j)
        tail = _tail(sc, pred_j, last_j)
        jf, jout = jtrack.fused_extract_track(
            jnp.asarray(img8), slice_case["jc"], slice_case["cfg"], H, W, *jstate,
            *[jnp.asarray(t) if isinstance(t, np.ndarray) else t for t in tail])
        pred_t = ttrack.predict_pose(last_t, prev_t)
        tf, tout = ttrack.fused_extract_track(torch.from_numpy(img8), cam, ext, **state,
                                              **_torch_tail(sc, pred_t, last_t))
        jp, jn, jok = np.asarray(jout[0]), int(jout[2]), bool(jout[4])
        tp, tn, tok = tout[0].numpy(), int(tout[2]), bool(tout[4])
        assert tok and jok, fid
        assert abs(tn - jn) <= 0.05 * jn, (fid, tn, jn)
        rot, trans = _rot_trans_diff(tp, jp)
        assert rot < 5e-3 and trans < 5e-3, (fid, rot, trans)
        for p in (tp, jp):
            assert pose_error(p, sc.poses[fid])[1] < 0.02, fid
        jstate[:6] = [jf["uv_und"], jf["desc_bits"], jf["size"], jf["angle"], jout[1], jout[6]]
        state.update(last_uv=tf["uv_und"], last_bits=tf["desc_bits"], last_size=tf["size"],
                     last_angle=tf["angle"], last_match_pt=tout[1], last_match_pos=tout[6])
        prev_j, last_j = last_j, jout[0]
        prev_t, last_t = last_t, tout[0]
    # on the CPU the wrappers took the plain twins: no kernel launched
    assert cuda_fast.fast_nms.launches == 0 and cuda_match.best_two.launches == 0


def test_flagship_tracking_step_matches_jax():
    ex = jflag.make_example(120, 160)
    cfg = jext.ExtractorConfig(n_features=1000)
    jpose_, jn, jf = jflag.tracking_step(*map(jnp.asarray, ex[:7]), *ex[7:], cfg=cfg,
                                         height=120, width=160)
    ext = OrbExtractor(ExtractorConfig(n_features=1000), 120, 160)
    tpose_, tn, tf = tflag.tracking_step(*tflag.example_on("cpu", 120, 160), extractor=ext)
    assert tpose_.shape == (4, 4) and bool(torch.isfinite(tpose_).all())
    assert tf["xy"].shape == (1000, 2) and tf["desc_bits"].shape == (1000, 256)
    assert abs(int(tn) - int(jn)) <= 0.01 * max(int(jn), 100)
    assert np.abs(tpose_.numpy() - np.asarray(jpose_)).max() < 1e-3
    valid_t, valid_j = tf["valid"].numpy(), np.asarray(jf["valid"])
    assert abs(int(valid_t.sum()) - int(valid_j.sum())) <= 0.01 * valid_j.sum()
    assert cuda_fast.fast_nms.launches == 0 and cuda_match.best_two.launches == 0


def test_searches_on_once_packed_words_equal_unpacked(slice_case, monkeypatch):
    """fused_track_step packs the frame's descriptors once; the motion
    search, its retry and the local-map search on those words give exactly
    what each search gives when it packs its own candidates."""
    sc, f = slice_case["sc"], slice_case["feats13"]
    state = convert.track_state_from_numpy(slice_case["carry"], slice_case["ref"],
                                           slice_case["block"], "cpu")
    cur = [torch.from_numpy(f[k]) for k in ("uv_und", "desc_bits", "size", "angle", "valid")]
    f_uv, f_bits, f_size, f_angle, f_valid = cur
    words = cuda_match.pack_bits(f_bits)
    last = torch.from_numpy(sc.poses[FIRST_TRACKED - 1])
    lo, hi = (torch.from_numpy(b) for b in sc.bounds)
    blk = [state[k] for k in convert.BLOCK_KEYS[1:]]
    p = TRACK_PARAMS
    local = [*blk, last, sc.fx, sc.fy, sc.cx, sc.cy, lo, hi, f_uv, f_bits, f_size, f_valid,
             p["local_radius"], p["match_th"], p["local_ratio"]]
    has_pt = state["last_match_pt"] >= 0
    uv_proj = state["last_uv"]  # the last frame's keypoints as their own projections
    motion = [state["last_uv"], state["last_bits"], state["last_size"], has_pt, uv_proj,
              has_pt, f_uv, f_bits, f_size, f_valid, state["last_angle"], f_angle,
              p["motion_radius"], p["match_th"], p["min_motion_matches"]]
    for fn, args in ((ttrack.frame_ops.project_and_match, local),
                     (ttrack.frame_ops.match_frame_to_frame_2r, motion)):
        got, want = fn(*args, f_words=words), fn(*args)
        assert set(got) == set(want) and int(want["valid"].sum()) > 0
        for k in want:
            assert torch.equal(got[k], want[k]), (fn.__name__, k)

    packed = []
    pack = cuda_match.pack_bits
    monkeypatch.setattr(cuda_match, "pack_bits", lambda bits: packed.append(bits) or pack(bits))
    pred = ttrack.predict_pose(last, torch.from_numpy(sc.poses[FIRST_TRACKED - 2]))
    out = ttrack.fused_track_step(*cur, torch.from_numpy(f["inv_sigma2"]), **state,
                                  **_torch_tail(sc, pred, last))
    assert bool(out[4]) and bool(out[5])  # tracked by the motion model
    assert len(packed) == 1 and packed[0] is f_bits


def test_flagship_entry_runs_on_the_card_by_default():
    import inspect

    assert inspect.signature(tflag.entry).parameters["device"].default == "cuda"
