"""Local mapping of the PyTorch port against the JAX package: one keyframe
event (LocalMapper.process_keyframe: recent-point culling, triangulation,
fusion, local BA, keyframe culling), both fusion directions, and the
device point mirror. The map they start from is a real one: the port's
System over the first frames of the rendered benchmark scene at 320x240
(600 orb32 features), captured just before its last keyframe event and
copied into a SlamMap of each package.

Tolerances and why:
- fusion searches: indices and masks exactly equal (integer Hamming
  distances, the same gates on float32 projections of the same inputs);
- the point mirror: gathered rows exactly equal to the port's host rows,
  and to the JAX mirror's (floats within 1e-6: the JAX package
  recomputes point statistics in its C++ library, the port in numpy,
  with other float32 summation orders);
- the keyframe event: the same keyframes alive; point counts within 2%
  and >= 98% of the match table equal, since triangulation and BA
  outlier gates are thresholds on float32 results; keyframe poses within
  2e-3 and surviving points within 1e-2 map units (float32 LM with other
  summation orders; the map's scale is about 2 m).
"""

import copy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu.ops.camera import CameraParams as JaxCamera
from anyfeature_vslam_tpu.slam import frame_ops as jframe
from anyfeature_vslam_tpu.slam import local_mapping as jlm
from anyfeature_vslam_tpu.slam.map_state import SlamMap as JaxMap
from anyfeature_vslam_tpu_torch.slam import frame_ops as tframe
from anyfeature_vslam_tpu_torch.slam import local_mapping as tlm
from anyfeature_vslam_tpu_torch.system import System
from span_trace import Tracing
from torch_slice_scene import SliceScene

W, H, N_FEATURES, N_FRAMES = 320, 240, 600, 6
T = torch.from_numpy


@pytest.fixture(scope="module")
def snapshot():
    """(scene, port map, recent points, processed count, keyframe) just
    before the last keyframe event of a port run."""
    sc = SliceScene(W, H)
    system = System(JaxCamera.create(**sc.camera), feature="orb32", n_features=N_FEATURES,
                    async_mapping=False, device="cpu")
    snaps = []
    event = system.tracker.on_new_keyframe

    def capture(kf):
        mapper = system.local_mapper
        m = copy.copy(system.map)
        m.__dict__ = {k: copy.deepcopy(v) for k, v in vars(system.map).items()
                      if k != "_mirror"}
        m._mirror = None
        snaps.append((m, dict(mapper.recent), mapper.n_kf_processed, kf))
        event(kf)

    system.tracker.on_new_keyframe = capture
    for i in range(N_FRAMES):
        system.track_monocular(sc.render(i)[0], i / 30.0)
    assert system.tracker.stats["resets"] == 0 and len(snaps) >= 4
    return (sc,) + snaps[-1]


def _port_map(snap):
    m = copy.deepcopy(snap)
    m._mirror = None
    return m


def _jax_map(snap):
    jm = JaxMap(snap.max_kf, snap.max_pt, snap.n_feat, snap.desc_dim, np.uint8)
    for k, v in vars(snap).items():
        if k not in ("_mirror", "device", "_obs_counts_cache"):
            setattr(jm, k, copy.deepcopy(v))
    return jm


def test_process_keyframe_matches_jax(snapshot):
    sc, snap, recent, n_done, kf = snapshot
    jmap, tmap = _jax_map(snap), _port_map(snap)
    jm = jlm.LocalMapper(jmap, JaxCamera.create(**sc.camera), match_th=75.0,
                         size_tolerance=1.2)
    tm = tlm.LocalMapper(tmap, (sc.fx, sc.fy, sc.cx, sc.cy), W, H, match_th=75.0,
                         size_tolerance=1.2, device="cpu")
    for mapper in (jm, tm):
        mapper.recent = dict(recent)
        mapper.n_kf_processed = n_done
    jm.process_keyframe(kf)
    with Tracing() as rec:
        tm.process_keyframe(kf)
    assert np.array_equal(tmap.kf_valid, jmap.kf_valid)
    assert abs(tmap.n_points() - jmap.n_points()) <= 0.02 * jmap.n_points()
    live = jmap.keyframe_ids()
    assert np.mean(tmap.kf_matches[live] == jmap.kf_matches[live]) >= 0.98
    assert np.abs(tmap.kf_pose[live] - jmap.kf_pose[live]).max() < 2e-3
    both = tmap.pt_valid & jmap.pt_valid
    assert both.sum() >= 0.95 * jmap.n_points()
    assert np.abs(tmap.pt_pos[both] - jmap.pt_pos[both]).max() < 1e-2
    # the event ran every stage, each once
    assert rec.stages("map.") == {"stats+cullpts": 1, "triangulate": 1, "fuse": 1,
                                  "local_ba": 1, "cullkfs": 1}
    assert tm.ba_log and tm.ba_log[-1]["dense"]


def _fusion_inputs(sc, snap, kf):
    """Direction A and B inputs of the event's fusion, as the mappers build
    them: the keyframe's points into its covisible targets, and the
    targets' points into the keyframe."""
    m = snap
    first, _ = m.covisible_keyframes(kf, min_weight=15, max_n=20)
    targets = [int(t) for t in first if int(t) != kf][:4]
    assert targets
    n = m.n_feat
    mm = m.kf_matches[kf]
    pt_ids = np.unique(mm[mm >= 0])
    idx_a = np.zeros(n, np.int64)
    idx_a[: len(pt_ids)] = pt_ids
    valid_a = np.zeros((len(targets), n), bool)
    for ti, t in enumerate(targets):
        has = np.zeros(m.max_pt, bool)
        dm = m.kf_matches[t]
        has[dm[dm >= 0]] = True
        valid_a[ti, : len(pt_ids)] = ~has[pt_ids]
    idx_b = np.zeros((len(targets), n), np.int64)
    valid_b = np.zeros((len(targets), n), bool)
    kf_has = np.zeros(m.max_pt, bool)
    kf_has[mm[mm >= 0]] = True
    for ti, t in enumerate(targets):
        dm = m.kf_matches[t]
        pts = np.unique(dm[dm >= 0])
        pts = pts[~kf_has[pts]][:n]
        idx_b[ti, : len(pts)] = pts
        valid_b[ti, : len(pts)] = True
    fields = ("pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_ref_size",
              "pt_ref_dist", "pt_desc_bits")
    rows_a = [getattr(m, f)[idx_a] for f in fields]
    rows_b = [getattr(m, f)[idx_b] for f in fields]
    feats = [(m.kf_uv[t], m.kf_desc_bits[t], m.kf_size[t], m.kf_feat_valid[t]) for t in targets]
    kf_feats = (m.kf_uv[kf], m.kf_desc_bits[kf], m.kf_size[kf], m.kf_feat_valid[kf])
    return targets, rows_a, valid_a, rows_b, valid_b, feats, kf_feats


def test_fusion_both_directions_match_jax(snapshot):
    sc, snap, _, _, kf = snapshot
    targets, rows_a, valid_a, rows_b, valid_b, feats, kf_feats = _fusion_inputs(sc, snap, kf)
    cam = (float(sc.fx), float(sc.fy), float(sc.cx), float(sc.cy))
    lo, hi = np.zeros(2, np.float32), np.array([W, H], np.float32)
    poses = snap.kf_pose[targets]
    want_a = jframe.fuse_points_into_targets(
        *map(jnp.asarray, rows_a), jnp.asarray(valid_a), jnp.asarray(poses),
        *(tuple(jnp.asarray(f[i]) for f in feats) for i in range(4)), *cam,
        jnp.asarray(lo), jnp.asarray(hi), 3.0, 75.0)
    got_a = tframe.fuse_points_into_targets(
        *map(T, rows_a), T(valid_a), T(poses), *([T(f[i]) for f in feats] for i in range(4)),
        *cam, T(lo), T(hi), 3.0, 75.0)
    want_b = jframe.fuse_target_points_into_kf(
        *map(jnp.asarray, rows_b), jnp.asarray(valid_b), jnp.asarray(snap.kf_pose[kf]),
        *map(jnp.asarray, kf_feats), *cam, jnp.asarray(lo), jnp.asarray(hi), 3.0, 75.0)
    got_b = tframe.fuse_target_points_into_kf(
        *map(T, rows_b), T(valid_b), T(snap.kf_pose[kf]), *map(T, kf_feats), *cam, T(lo), T(hi),
        3.0, 75.0)
    for (gi, gv), (wi, wv) in ((got_a, want_a), (got_b, want_b)):
        wv = np.asarray(wv)
        assert np.array_equal(gv.numpy(), wv) and wv.sum() > 0
        assert np.array_equal(gi.numpy()[wv], np.asarray(wi)[wv])


def test_device_point_mirror_matches_jax(snapshot):
    sc, snap, _, _, kf = snapshot
    jmap, tmap = _jax_map(snap), _port_map(snap)
    rng = np.random.default_rng(0)
    valid_ids = np.nonzero(snap.pt_valid)[0]

    fields = ("pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_ref_size",
              "pt_ref_dist", "pt_desc_bits", "pt_valid")

    def gather_equal(ids):
        want = [np.asarray(x) for x in jmap.mirror().gather(ids)]
        got = [x.numpy() for x in tmap.mirror().gather(ids)]
        safe = np.maximum(ids, 0)
        for name, w, g in zip(fields, want, got):
            host = getattr(tmap, name)[safe]
            if name == "pt_valid":
                host = host & (ids >= 0)
            # the port's mirror holds exactly its host rows; the packages'
            # point statistics differ only in float32 summation order
            assert np.array_equal(g, host), name
            if g.dtype == np.float32:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)
            else:
                assert np.array_equal(g, w), name

    ids = np.concatenate([rng.choice(valid_ids, 300), [-1, -1, 0]]).astype(np.int32)
    gather_equal(ids)
    gather_equal(ids.reshape(3, 101))
    # host mutations reach the mirror through the dirty rows
    for m in (jmap, tmap):
        m.remove_points(valid_ids[:20])
        new = m.add_points(np.ones((5, 3), np.float32), m.pt_desc_bits[valid_ids[:5]], kf,
                           np.ones(5, np.float32))
        m.pt_pos[valid_ids[30:40]] += 0.5
        m.mark_points_dirty(valid_ids[30:40])
        m.update_point_stats(valid_ids[40:80])
    gather_equal(np.concatenate([valid_ids[:100], new, [-1]]).astype(np.int32))
    # growing the capacity re-uploads the whole mirror
    for m in (jmap, tmap):
        m._grow_points(m.max_pt + 10)
    gather_equal(np.concatenate([valid_ids[:100], [m.max_pt - 1]]).astype(np.int32))
