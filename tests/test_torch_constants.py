"""Constants copied into the PyTorch port equal the JAX package's, bit for
bit, and the port imports neither jax nor PIL."""

import os
import subprocess
import sys
from dataclasses import fields

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu.frontend import brief as jbrief
from anyfeature_vslam_tpu.frontend import extractor as jext
from anyfeature_vslam_tpu.frontend import fast as jfast
from anyfeature_vslam_tpu.frontend import orientation as jorient
from anyfeature_vslam_tpu.frontend import pyramid as jpyr
from anyfeature_vslam_tpu.frontend import select as jselect
from anyfeature_vslam_tpu.ops import camera as jcam
from anyfeature_vslam_tpu.ops import matching as jmatch
from anyfeature_vslam_tpu.ops import pallas_match as jpm
from anyfeature_vslam_tpu.ops import pose_opt as jpose
from anyfeature_vslam_tpu.slam import frame_ops as jframe
from anyfeature_vslam_tpu_torch.frontend import brief as tbrief
from anyfeature_vslam_tpu_torch.frontend import extractor as text
from anyfeature_vslam_tpu_torch.frontend import fast as tfast
from anyfeature_vslam_tpu_torch.frontend import orientation as torient
from anyfeature_vslam_tpu_torch.frontend import pyramid as tpyr
from anyfeature_vslam_tpu_torch.frontend import select as tselect
from anyfeature_vslam_tpu_torch.ops import camera as tcam
from anyfeature_vslam_tpu_torch.ops import matching as tmatch
from anyfeature_vslam_tpu_torch.ops import pose_opt as tpose
from anyfeature_vslam_tpu_torch.slam import frame_ops as tframe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_feature_registry_and_config():
    assert text.FEATURE_REGISTRY == jext.FEATURE_REGISTRY
    assert [f.name for f in fields(text.ExtractorConfig)] == [f.name for f in fields(jext.ExtractorConfig)]
    for name, entry in jext.FEATURE_REGISTRY.items():
        if entry[0] == "precomputed":
            continue
        for n in (500, 1000):
            t = text.ExtractorConfig.for_feature(name, n)
            j = jext.ExtractorConfig.for_feature(name, n)
            for attr in ("level_budgets", "level_scales", "capacity", "desc_dim"):
                assert getattr(t, attr) == getattr(j, attr), (name, attr)
    assert text.ORB_MAX_SIZE == jext.ORB_MAX_SIZE


def test_camera_params_layout():
    assert tcam.CameraParams._fields == jcam.CameraParams._fields
    t = tcam.CameraParams.create(1, 2, 3, 4, device="cpu")
    j = jcam.CameraParams.create(1, 2, 3, 4)
    for k in jcam.CameraParams._fields:
        assert float(getattr(t, k)) == float(getattr(j, k)), k


@pytest.mark.parametrize("hw", [(480, 640), (240, 320)])
def test_resize_weights_and_level_shapes(hw):
    shapes = tpyr.level_shapes(*hw, 8, 1.2)
    assert shapes == jpyr.level_shapes(*hw, 8, 1.2)
    for (h1, w1), (h2, w2) in zip(shapes[:-1], shapes[1:]):
        np.testing.assert_array_equal(tpyr.resize_weights_np(h1, h2), jpyr._resize_weights_np(h1, h2))
        np.testing.assert_array_equal(tpyr.resize_weights_np(w1, w2), jpyr._resize_weights_np(w1, w2))
    np.testing.assert_array_equal(tpyr.gaussian_kernel1d(2.0, 3), jpyr.gaussian_kernel1d(2.0, 3))


@pytest.mark.parametrize("n_bits", [256, 384, 488, 512])
def test_brief_pattern(n_bits):
    np.testing.assert_array_equal(tbrief.make_pattern(n_bits), jbrief.pattern(n_bits))


def test_brief_rotation_matrix_and_tables():
    m = tbrief.rotation_matrix_np(256)
    np.testing.assert_array_equal(m, jbrief._rot_mat(256))
    # the gather tables reproduce every column of the sampling matrix
    p1, p2 = tbrief.sample_index_tables_np(256)
    cols = np.zeros_like(m)
    flat_cols = np.arange(m.shape[1]).reshape(p1.shape)
    np.subtract.at(cols, (p1.ravel(), flat_cols.ravel()), 1.0)
    np.add.at(cols, (p2.ravel(), flat_cols.ravel()), 1.0)
    np.testing.assert_array_equal(cols, m)
    assert (tbrief.N_ROT, tbrief.PATCH_RADIUS, tbrief.N_BITS) == (jbrief.N_ROT, jbrief.PATCH_RADIUS, jbrief.N_BITS)


def test_orientation_and_detector_constants():
    np.testing.assert_array_equal(torient.moment_matrix_np(), jorient._MOMENT_MAT)
    assert torient.PATCH_RADIUS == jorient.PATCH_RADIUS
    assert tfast.CIRCLE_OFFSETS == jfast.CIRCLE_OFFSETS and tfast.ARC_LEN == jfast.ARC_LEN
    assert tselect.K_CELL == jselect.K_CELL


def test_matching_and_pose_constants():
    assert tmatch.INF == float(jmatch.INF) == jpm.INF
    assert (tmatch.HISTO_LENGTH, tmatch.RADIUS_SCALE) == (jmatch.HISTO_LENGTH, jmatch.RADIUS_SCALE)
    assert (tpose.CHI2_MONO, tpose.N_ROUNDS, tpose.N_ITERS, tpose.DX_TOL) == (
        jpose.CHI2_MONO, jpose.N_ROUNDS, jpose.N_ITERS, jpose.DX_TOL)
    assert np.float32(tpose.HUBER_DELTA) == np.float32(jpose.HUBER_DELTA)
    assert tframe.MAX_SIZE == jframe.MAX_SIZE


def test_normalized_sizes():
    for name in ("orb32", "brisk48"):
        cfg = jext.ExtractorConfig.for_feature(name)
        octave = jnp.arange(cfg.n_levels, dtype=jnp.float32)
        want = np.asarray(jext._normalized_size(cfg, octave))
        np.testing.assert_allclose(text._normalized_size_np(cfg), want, rtol=2e-7, atol=0)


def test_port_imports_neither_jax_nor_pil():
    code = (
        "import pkgutil, importlib, sys\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'tests')!r}]\n"
        "import anyfeature_vslam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import torch_slice_scene\n"
        "assert 'anyfeature_vslam_tpu_torch.slam.fast_track' in mods, mods\n"
        "for m in ('place_recognition.vocab', 'place_recognition.database', 'slam.loop_closing',\n"
        "          'ops.pnp', 'ops.sim3', 'ops.pose_graph'):\n"
        "    assert 'anyfeature_vslam_tpu_torch.' + m in mods, (m, mods)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'PIL', 'anyfeature_vslam_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


# --------------------------------------------- host copies: map, io, counters

def _scripted_maps():
    """The same series of map operations on a SlamMap of each package."""
    from anyfeature_vslam_tpu.slam.map_state import SlamMap as JaxMap
    from anyfeature_vslam_tpu_torch.slam.map_state import SlamMap as PortMap

    rng = np.random.default_rng(0)
    n, n_pts = 64, 120
    feats = []
    for k in range(5):
        feats.append(dict(
            uv_und=rng.uniform(0, 320, (n, 2)).astype(np.float32),
            desc_bits=rng.integers(0, 2, (n, 256)).astype(np.uint8),
            octave=rng.integers(0, 8, n).astype(np.int32),
            size=rng.choice([1.0, 1.2, 1.44], n).astype(np.float32),
            angle=rng.uniform(0, 6.28, n).astype(np.float32),
            inv_sigma2=rng.uniform(0.5, 1, n).astype(np.float32),
            valid=rng.random(n) < 0.95))
    poses = []
    for k in range(5):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [0.1 * k, 0.02 * k, 0.0]
        poses.append(t)
    pos = rng.uniform([-1, -1, 2], [1, 1, 4], (n_pts, 3)).astype(np.float32)
    bits = rng.integers(0, 2, (n_pts, 256)).astype(np.uint8)
    maps = []
    for cls in (JaxMap, PortMap):
        m = cls(max_kf=4, max_pt=100, n_feat=n, desc_dim=256)
        kfs = [m.add_keyframe(poses[k], 0.1 * k, 3 * k, feats[k], np.full(n, -1, np.int32))
               for k in range(5)]  # the fifth grows the keyframe capacity
        # more points than max_pt: grows the point capacity
        ids = m.add_points(pos, bits, kfs[0], np.ones(n_pts, np.float32))
        for k in kfs:
            slots = np.arange(n)[(np.arange(n) + k) % 3 != 0]
            m.kf_matches[k][slots] = ids[(slots * (k + 1)) % n_pts]
        m.update_point_stats(ids)
        m.merge_points([int(ids[0]), int(ids[1])], [int(ids[2]), int(ids[3])])
        m.remove_points(ids[10:14])
        m.update_point_stats()
        m.remove_keyframe(kfs[2])
        maps.append(m)
    return maps


def test_map_state_copy_matches_jax():
    jm, tm = _scripted_maps()
    for name, v in vars(jm).items():
        if not isinstance(v, np.ndarray) or name == "pt_dirty":
            continue
        got = getattr(tm, name)
        if v.dtype == np.float32:
            np.testing.assert_allclose(got, v, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            assert np.array_equal(got, v), name
    assert jm.uid_slot == tm.uid_slot and jm.rev == tm.rev
    assert sorted(jm.retired_kfs) == sorted(tm.retired_kfs)
    for kf in jm.keyframe_ids():
        assert np.array_equal(tm.covisibility_weights(kf), jm.covisibility_weights(kf))
        for mw in (1, 15):
            a, b = tm.covisible_keyframes(kf, min_weight=mw), jm.covisible_keyframes(kf, mw)
            assert np.array_equal(a[0], b[0])
    for sw in (False, True):
        assert np.array_equal(tm.point_observation_counts(sw), jm.point_observation_counts(sw))
    ids = np.nonzero(jm.pt_valid)[0][:30]
    for a, b in zip(tm.observations_of_points(ids), jm.observations_of_points(ids)):
        assert np.array_equal(a, b)
    uid = next(iter(jm.retired_kfs))
    np.testing.assert_allclose(tm.resolve_anchor(np.eye(4), uid), jm.resolve_anchor(np.eye(4), uid),
                               rtol=1e-6, atol=1e-6)
    assert tm.FREED_QUARANTINE_REVS == jm.FREED_QUARANTINE_REVS


def test_trajectory_writers_match_jax(tmp_path):
    from anyfeature_vslam_tpu.io import trajectory as jtraj
    from anyfeature_vslam_tpu.ops import se3 as jse3
    from anyfeature_vslam_tpu_torch.io import trajectory as ttraj
    from anyfeature_vslam_tpu_torch.ops import se3 as tse3

    jm, tm = _scripted_maps()
    rng = np.random.default_rng(2)
    rots = np.array(jse3.so3_exp(jnp.asarray(rng.normal(0, 1.5, (64, 3)).astype(np.float32))))
    np.testing.assert_allclose(tse3.rot_to_quat(torch.from_numpy(rots)).numpy(),
                               np.asarray(jse3.rot_to_quat(jnp.asarray(rots))), atol=1e-6)
    traj = [(0.1 * i, np.eye(4, dtype=np.float32), int(jm.kf_uid[jm.keyframe_ids()[i % 3]]),
             i == 4) for i in range(6)]
    traj.append((0.9, np.eye(4, dtype=np.float32), next(iter(jm.retired_kfs)), False))
    for mod, m, d in ((jtraj, jm, "j"), (ttraj, tm, "t")):
        os.makedirs(tmp_path / d)
        mod.save_keyframe_trajectory_vslamlab(str(tmp_path / d / "kf.csv"), m)
        mod.save_frame_trajectory_tum(str(tmp_path / d / "tum.txt"), traj, m)
        mod.save_frame_trajectory_kitti(str(tmp_path / d / "kitti.txt"), traj, m)
        mod.save_statistics_yaml(str(tmp_path / d / "stats.yaml"), m, dict(resets=0))
    for f in ("kf.csv", "tum.txt", "kitti.txt", "stats.yaml"):
        assert (tmp_path / "t" / f).read_text() == (tmp_path / "j" / f).read_text(), f


def test_perfcount_copy_matches_jax():
    from anyfeature_vslam_tpu import perfcount as jpc
    from anyfeature_vslam_tpu_torch import perfcount as tpc

    for pc in (jpc, tpc):
        pc.reset()
        pc.bump("a")
        pc.bump("a", 2.5)
        with pc.timed_fetch():
            pass
        pc.trace_enabled = True
        pc.event("e", x=1)
        pc.trace_enabled = False
        pc.event("f")
    snap_j, snap_t = jpc.snapshot(), tpc.snapshot()
    assert snap_t.keys() == snap_j.keys() and snap_t["a"] == snap_j["a"] == 3.5
    assert snap_t["host_fetches"] == snap_j["host_fetches"] == 1
    assert [e[1:] for e in tpc.events()] == [e[1:] for e in jpc.events()]
    for pc in (jpc, tpc):
        pc.reset()
        pc.clear_events()


def test_evaluation_copy_matches_jax(tmp_path):
    from anyfeature_vslam_tpu.io import evaluation as jev
    from anyfeature_vslam_tpu_torch.io import evaluation as tev

    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 3))
    y = 1.7 * x @ np.asarray(jnp.eye(3))[::-1] + [0.3, -0.2, 1.0] + rng.normal(0, 0.01, (40, 3))
    for a, b in zip(tev.umeyama_alignment(x, y), jev.umeyama_alignment(x, y)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert tev.ate_rmse(x, y)[0] == jev.ate_rmse(x, y)[0]
    ts_a, ts_b = np.arange(40) / 30.0, np.arange(0, 40, 2) / 30.0 + 0.004
    for a, b in zip(tev.associate(ts_a, ts_b), jev.associate(ts_a, ts_b)):
        assert np.array_equal(a, b)
    est, gt = tmp_path / "est.txt", tmp_path / "gt.txt"
    for p, pts in ((est, x), (gt, y)):
        p.write_text("".join(f"{i / 30.0:.6f} {v[0]} {v[1]} {v[2]} 0 0 0 1\n"
                             for i, v in enumerate(pts)))
    assert tev.evaluate(str(est), str(gt)) == jev.evaluate(str(est), str(gt))


def test_threefry_draws_match_jax_random_uniform():
    import jax

    from anyfeature_vslam_tpu_torch.ops import rng

    for seed, shape in ((0, (200, 1999)), (3, (200, 7)), (2**31 - 1, (11,))):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
        got = rng.uniform(seed, shape)
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_place_recognition_host_copies_match_jax():
    """The numpy parts copied from the JAX package's vocab.py and
    database.py (k-means, distances, sparse bows, scoring, the query), the
    vocabulary file names and the loop-closing constants."""
    from anyfeature_vslam_tpu.io import dataset as jds
    from anyfeature_vslam_tpu.place_recognition import database as jdb
    from anyfeature_vslam_tpu.place_recognition import vocab as jvoc
    from anyfeature_vslam_tpu.slam import loop_closing as jlc
    from anyfeature_vslam_tpu.ops import pnp as jpnp
    from anyfeature_vslam_tpu.ops import pose_graph as jpg
    from anyfeature_vslam_tpu.ops import sim3 as jsim3
    from anyfeature_vslam_tpu_torch.io import dataset as tds
    from anyfeature_vslam_tpu_torch.place_recognition import database as tdb
    from anyfeature_vslam_tpu_torch.place_recognition import vocab as tvoc
    from anyfeature_vslam_tpu_torch.slam import loop_closing as tlc
    from anyfeature_vslam_tpu_torch.slam import tracking as ttrack
    from anyfeature_vslam_tpu_torch.ops import pnp as tpnp
    from anyfeature_vslam_tpu_torch.ops import pose_graph as tpg
    from anyfeature_vslam_tpu_torch.ops import sim3 as tsim3

    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, (40, 256)).astype(np.uint8)
    b = rng.integers(0, 2, (9, 256)).astype(np.uint8)
    np.testing.assert_array_equal(tvoc._dist(a, b), jvoc._dist(a, b))
    np.testing.assert_array_equal(tvoc._dist(a, b, chunk=7), jvoc._dist(a, b, chunk=7))
    f = rng.normal(size=(30, 64)).astype(np.float32)
    np.testing.assert_array_equal(tvoc._dist(f, f[:5]), jvoc._dist(f, f[:5]))
    for data in (a, f):
        for k in (4, 50):
            np.testing.assert_array_equal(
                tvoc._kmeans(data, k, 3, np.random.default_rng(5)),
                jvoc._kmeans(data, k, 3, np.random.default_rng(5)))
    voc = jvoc.train_vocabulary(a, branching=4, depth=2, iters=2)
    jd = jdb.KeyFrameDatabase(voc, 4)
    td = tdb.KeyFrameDatabase(tvoc.Vocabulary(voc.branching, voc.depth, voc.centroids, voc.idf),
                              4, device="cpu")
    words = rng.integers(-1, voc.n_words, 200)
    for x, y in zip(td.bow_from_words(words), jd.bow_from_words(words)):
        np.testing.assert_array_equal(x, y)
    bows = [jd.bow_from_words(rng.integers(-1, voc.n_words, 100)) for _ in range(7)]
    for kf, bow in enumerate(bows[:6]):
        jd.add(kf, bow=bow)
        td.add(kf, bow=bow)  # the sixth grows both tables
    assert td.max_kf == jd.max_kf and td._cap == jd._cap
    np.testing.assert_array_equal(td.kf_words, jd.kf_words)
    np.testing.assert_array_equal(td.kf_weights, jd.kf_weights)
    exclude = np.zeros(td.max_kf, bool)
    exclude[2] = True
    for x, y in zip(td._shared_and_scores(bows[6], exclude),
                    jd._shared_and_scores(bows[6], exclude)):
        np.testing.assert_array_equal(x, y)
    groups = {0: [1, 3], 1: [0], 4: [5, 2]}
    for order in (False, True):
        assert td._query(bows[6], exclude, 0.0, groups, order) == \
            jd._query(bows[6], exclude, 0.0, groups, order)
    assert tds.VOCAB_FILENAMES == jds.VOCAB_FILENAMES
    assert (tlc.MIN_BOW_MATCHES, tlc.MIN_SIM3_INLIERS, tlc.MIN_TOTAL_MATCHES,
            tlc.CONSISTENCY_TH, tlc.COVIS_EDGE_MIN_WEIGHT, tlc.SIM3_SEARCH_RADIUS,
            tlc.PROJ_GATE_RADIUS, tlc.FUSE_RADIUS) == (
        jlc.MIN_BOW_MATCHES, jlc.MIN_SIM3_INLIERS, jlc.MIN_TOTAL_MATCHES, jlc.CONSISTENCY_TH,
        jlc.COVIS_EDGE_MIN_WEIGHT, jlc.SIM3_SEARCH_RADIUS, jlc.PROJ_GATE_RADIUS,
        jlc.FUSE_RADIUS)
    for n in (10, 64, 65, 300, 1024, 1500):
        x = [np.arange(n, dtype=np.float32)]
        (pj,), vj = jlc._pad_pairs(x, n)
        (pt,), vt = tlc._pad_pairs(x, n)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(vt, vj)
    assert (tpnp.RANSAC_TH2, tpnp.MIN_SET) == (jpnp.RANSAC_TH2, jpnp.MIN_SET)
    assert (tsim3.CHI2_INLIER, tsim3.MIN_SET) == (jsim3.CHI2_INLIER, jsim3.MIN_SET)
    assert tpg.N_ITERS == jpg.N_ITERS
    assert ttrack.RELOC_MAX_CANDIDATES == 8


def test_find_vocabulary_matches_jax(tmp_path):
    from anyfeature_vslam_tpu.io import dataset as jds
    from anyfeature_vslam_tpu_torch.io import dataset as tds

    (tmp_path / "orb32_voc.npz").write_bytes(b"")
    (tmp_path / "Brisk_DBoW2_voc.txt").write_text("")
    for feat in ("orb32", "brisk48", "sift128"):
        assert tds.find_vocabulary(str(tmp_path), feat) == jds.find_vocabulary(str(tmp_path), feat)
