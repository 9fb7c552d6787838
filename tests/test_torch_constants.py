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
from anyfeature_vslam_tpu.frontend import dog as jdog
from anyfeature_vslam_tpu.frontend import fast as jfast
from anyfeature_vslam_tpu.frontend import graddesc as jgrad
from anyfeature_vslam_tpu.frontend import mldb as jmldb
from anyfeature_vslam_tpu.frontend import msurf as jmsurf
from anyfeature_vslam_tpu.frontend import nonlinear as jnl
from anyfeature_vslam_tpu.frontend import orientation as jorient
from anyfeature_vslam_tpu.frontend import pyramid as jpyr
from anyfeature_vslam_tpu.frontend import scalespace as jss
from anyfeature_vslam_tpu.frontend import select as jselect
from anyfeature_vslam_tpu.io import precomputed as jpre
from anyfeature_vslam_tpu.ops import camera as jcam
from anyfeature_vslam_tpu.ops import matching as jmatch
from anyfeature_vslam_tpu.ops import pallas_match as jpm
from anyfeature_vslam_tpu.ops import pose_opt as jpose
from anyfeature_vslam_tpu.slam import frame_ops as jframe
from anyfeature_vslam_tpu_torch.frontend import brief as tbrief
from anyfeature_vslam_tpu_torch.frontend import extractor as text
from anyfeature_vslam_tpu_torch.frontend import dog as tdog
from anyfeature_vslam_tpu_torch.frontend import fast as tfast
from anyfeature_vslam_tpu_torch.frontend import graddesc as tgrad
from anyfeature_vslam_tpu_torch.frontend import mldb as tmldb
from anyfeature_vslam_tpu_torch.frontend import msurf as tmsurf
from anyfeature_vslam_tpu_torch.frontend import nonlinear as tnl
from anyfeature_vslam_tpu_torch.frontend import orientation as torient
from anyfeature_vslam_tpu_torch.frontend import pyramid as tpyr
from anyfeature_vslam_tpu_torch.frontend import scalespace as tss
from anyfeature_vslam_tpu_torch.frontend import select as tselect
from anyfeature_vslam_tpu_torch.io import precomputed as tpre
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
    for name in ("orb32", "brisk48", "akaze61"):
        cfg = jext.ExtractorConfig.for_feature(name)
        octave = jnp.arange(cfg.n_levels, dtype=jnp.float32)
        want = np.asarray(jext._normalized_size(cfg, octave))
        np.testing.assert_allclose(text._normalized_size_np(cfg), want, rtol=2e-7, atol=0)


# the level scales of akaze61 / kaze64 (1.6 * 2^(j/4), j = 0..3): every level's
# sigma_rel, and kaze64's decimated spacing, is one of them
NONLINEAR_SCALES = tuple(1.6 * 2.0 ** (j / 4) for j in range(4))


def test_nonlinear_constants_and_fed_steps():
    for name in ("TAU_MAX", "SIGMA0", "K_PERCENTILE", "K_NBINS", "_SCHARR_EDGE", "_SCHARR_MID"):
        assert getattr(tnl, name) == getattr(jnl, name), name
    # the FED steps between the levels of build_evolution, both schedules
    for ds, counts in ((True, [0, 3, 3, 4, 2, 3, 3, 4]), (False, [0, 3, 3, 4, 4, 5, 6, 7])):
        plans = tnl.plan_levels(480, 640, 8, ds)
        assert [len(p.taus) for p in plans] == counts
        t_prev = 0.5 * jnl.SIGMA0 ** 2
        for p in plans:
            t = 0.5 * p.sigma ** 2
            div = 4.0 ** p.octave if ds else 1.0
            if p.index:
                assert list(p.taus) == jnl.fed_tau_steps((t - t_prev) / div)
            assert p.sigma_rel == (p.sigma / 2 ** p.octave if ds else p.sigma)
            t_prev = t
    for total in (0.0, 0.3, 1.7, 5.12, 20.0):
        assert tnl.fed_tau_steps(total) == jnl.fed_tau_steps(total)


@pytest.mark.parametrize("scale", NONLINEAR_SCALES)
def test_mldb_matrices(scale):
    radius = tmldb.patch_radius(scale)
    assert radius == jmldb.patch_radius(scale)
    np.testing.assert_array_equal(tmldb._cell_matrix(scale, radius),
                                  jmldb._cell_matrix(scale, radius))
    np.testing.assert_array_equal(tmldb._orientation_matrix(scale, radius),
                                  jmldb._orientation_matrix(scale, radius))


def test_mldb_pairs_and_constants():
    for name in ("GRIDS", "N_CELLS", "N_PAIRS", "N_BITS", "N_BITS_PADDED", "PATTERN_SIZE",
                 "N_ROT", "N_ORI_BINS", "ORI_WINDOW"):
        assert getattr(tmldb, name) == getattr(jmldb, name), name
    np.testing.assert_array_equal(tmldb._ORI_IJ, jmldb._ORI_IJ)
    for got, want in zip(tmldb._pair_matrices(), jmldb._pair_matrices()):
        np.testing.assert_array_equal(got, want)
    # the index form picks exactly the selectors' cells
    a, b = jmldb._pair_matrices()
    idx = tmldb.pair_indices().numpy()
    np.testing.assert_array_equal(np.eye(a.shape[0], dtype=np.float32)[:, idx[0]], a)
    np.testing.assert_array_equal(np.eye(b.shape[0], dtype=np.float32)[:, idx[1]], b)


@pytest.mark.parametrize("scale", NONLINEAR_SCALES)
def test_msurf_sample_matrix(scale):
    radius = tmsurf.patch_radius(scale)
    assert radius == jmsurf.patch_radius(scale)
    np.testing.assert_array_equal(tmsurf._sample_matrix(scale, radius),
                                  jmsurf._sample_matrix(scale, radius))


def test_msurf_cell_weights_and_constants():
    for name in ("CELLS", "HALF_CELLS", "CELL_SIZE", "LATTICE", "_N_SAMP", "N_ROT",
                 "WEIGHT_SIGMA"):
        assert getattr(tmsurf, name) == getattr(jmsurf, name), name
    np.testing.assert_array_equal(tmsurf._LX, jmsurf._LX)
    np.testing.assert_array_equal(tmsurf._LY, jmsurf._LY)
    np.testing.assert_array_equal(tmsurf._cell_weights(), jmsurf._cell_weights())


def test_graddesc_constants():
    for name in ("PATCH", "CELLS", "_SPACING", "N_ROT", "PATCH_RADIUS", "_P", "_N_SAMP",
                 "N_ORI_BINS"):
        assert getattr(tgrad, name) == getattr(jgrad, name), name
    np.testing.assert_array_equal(tgrad._CELL_OF, jgrad._CELL_OF)
    np.testing.assert_array_equal(tgrad._cell_matrix(), jgrad._CELL_MAT)
    np.testing.assert_array_equal(tgrad._ori_weight_np(), jgrad._ORI_W)
    # the rotation table is what jnp.cos / jnp.sin give at each step's angle
    th = jnp.arange(jgrad.N_ROT).astype(jnp.float32) * (2.0 * jnp.pi / jgrad.N_ROT)
    np.testing.assert_array_equal(tgrad._rotation_table_np(),
                                  np.stack([np.asarray(jnp.cos(th)), np.asarray(jnp.sin(th))], 1))
    sample, cell, rot, ori = tgrad.tensors()
    np.testing.assert_array_equal(sample.numpy(), np.asarray(
        jnp.asarray(jgrad._sample_mat(), jnp.bfloat16).astype(jnp.float32)))
    assert cell.shape == (400, 16) and rot.shape == (16, 2) and ori.shape == (961,)


def test_scalespace_and_dog_constants():
    for name in ("SIGMA0", "ASSUMED_BLUR", "EDGE_R", "MIN_OCTAVE_DIM"):
        assert getattr(tss, name) == getattr(jss, name), name
    assert (tdog.SIGMA_A, tdog.SIGMA_B) == (jdog.SIGMA_A, jdog.SIGMA_B)
    for nspo in (1, 2, 3):
        assert tss.slice_sigmas(nspo) == jss.slice_sigmas(nspo)
    for h, w in ((480, 640), (240, 320), (120, 160), (64, 64), (31, 40)):
        for m in (1, 4, 8):
            assert tss.n_octaves(h, w, m) == jss.n_octaves(h, w, m)
        assert tss.octave_shape(h, w) == jss.downsample2(jnp.zeros((h, w))).shape
    # the blurs' taps: JAX's sigma and radius at every call site
    sig = jss.slice_sigmas(2)
    incs = [float(np.sqrt(sig[i] ** 2 - sig[i - 1] ** 2)) for i in range(1, 5)]
    assert tss.increment_sigmas(2) == incs
    inc0 = float(np.sqrt(jss.SIGMA0 ** 2 - jss.ASSUMED_BLUR ** 2))
    assert tss.base_sigma() == inc0
    for s in incs + [inc0, 2.0]:
        np.testing.assert_array_equal(
            tss.taps(s).numpy(), jpyr.gaussian_kernel1d(s, max(int(np.ceil(3 * s)), 1)))
    for t, (s, r) in zip(tdog.tensors("dog"), ((jdog.SIGMA_A, 3), (jdog.SIGMA_B, 5))):
        np.testing.assert_array_equal(t.numpy(), jpyr.gaussian_kernel1d(s, r))
    np.testing.assert_array_equal(tdog.tensors("hessian")[0].numpy(),
                                  jpyr.gaussian_kernel1d(2.0, 6))


def test_sift_unit_budgets():
    for total in (500, 600, 1000, 1200, 2000):
        for n_units, nspo in ((6, 2), (8, 2), (4, 1), (9, 3)):
            got = text._sift_unit_budgets(total, n_units, nspo)
            assert got == jext._sift_unit_budgets(total, n_units, nspo)
            assert sum(got) == total


def test_precomputed_copy_matches_jax(tmp_path):
    assert tpre.ORB_MAX_SIZE == jpre.ORB_MAX_SIZE
    rng = np.random.default_rng(0)
    path = str(tmp_path / "seq" / "rgb" / "000007.png")
    assert tpre.feature_paths(path) == jpre.feature_paths(path)
    assert tpre.feature_paths(path, "sp") == jpre.feature_paths(path, "sp")
    kp_path, sc_path, de_path = tpre.feature_paths(path)
    for p in (kp_path, sc_path, de_path):
        os.makedirs(os.path.dirname(p))
    # ties in the scores (a stable sort), sizes spread and equal
    for n, sizes in ((50, rng.uniform(1, 9, 50)), (30, np.full(30, 3.0))):
        kps = np.stack([rng.uniform(0, 640, n), rng.uniform(0, 480, n), sizes], 1)
        np.concatenate([kps, kps[:5]]).tofile(kp_path)
        np.round(rng.uniform(0, 1, n + 5), 1).tofile(sc_path)
        rng.normal(size=(n + 3, 128)).tofile(de_path)
        for cap in (10, n, 2 * n):
            want = jpre.load_precomputed_features(path, cap)
            got = tpre.load_precomputed_features(path, cap)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(tpre.load_bin(kp_path, 3), jpre.load_bin(kp_path, 3))
    for mod in (tpre, jpre):
        with pytest.raises(ValueError, match="not divisible"):
            mod.load_bin(de_path, 7)


def test_port_imports_neither_jax_nor_pil():
    code = (
        "import pkgutil, importlib, sys\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'tests')!r}]\n"
        "import anyfeature_vslam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import torch_slice_scene, r2d2_scene\n"
        "assert 'anyfeature_vslam_tpu_torch.slam.fast_track' in mods, mods\n"
        "for m in ('place_recognition.vocab', 'place_recognition.database', 'slam.loop_closing',\n"
        "          'ops.pnp', 'ops.sim3', 'ops.pose_graph', 'frontend.scalespace',\n"
        "          'frontend.dog', 'frontend.graddesc', 'io.precomputed',\n"
        "          'place_recognition.dbow2_io', 'io.viewer', 'parallel.sharded_ba',\n"
        "          'parallel.point_sharded_ba', 'io.png', 'tools.evaluate_ate',\n"
        "          'tools.make_synth_sequence', 'tools.create_vocabulary',\n"
        "          'tools.train_patch_descriptor', 'tools.bench_ba', 'tools.profile_detect',\n"
        "          'tools.profile_tracking', 'native'):\n"
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


def test_port_ships_the_learned48_weights():
    """The port's learned48.npz lies in the port and equals the JAX
    package's file array for array."""
    from anyfeature_vslam_tpu.frontend import learned48 as jl48
    from anyfeature_vslam_tpu_torch.frontend import learned48 as tl48

    port_dir = os.path.join(ROOT, "anyfeature_vslam_tpu_torch")
    assert os.path.commonpath([tl48.WEIGHTS_PATH, port_dir]) == port_dir
    got, want = tl48.load_weights(), jl48.load_weights()
    assert set(got) == set(want) == {"w1", "b1", "w2", "b2", "w3", "b3"}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _code_strings(path):
    """The string constants of a module that are not docstrings."""
    import ast

    tree = ast.parse(open(path).read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_no_port_module_names_a_jax_package_path():
    """No module of the port builds a path into the JAX package: no string
    in its code (docstrings aside) names the folder anyfeature_vslam_tpu/ or
    is that folder's name as a path segment."""
    port_dir = os.path.join(ROOT, "anyfeature_vslam_tpu_torch")
    bad = []
    for base, _, files in os.walk(port_dir):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(base, name)
                bad += [(os.path.relpath(path, ROOT), s) for s in _code_strings(path)
                        if "anyfeature_vslam_tpu/" in s or s == "anyfeature_vslam_tpu"]
    assert not bad, bad


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
    snap_j, snap_t = jpc.snapshot(), tpc.snapshot()
    assert snap_t.keys() == snap_j.keys() and snap_t["a"] == snap_j["a"] == 3.5
    assert snap_t["host_fetches"] == snap_j["host_fetches"] == 1
    assert tpc.get("a") == jpc.get("a") == 3.5 and tpc.get("b") == jpc.get("b") == 0.0
    # the port's event list became its span recorder (perfcount.span)
    assert not hasattr(tpc, "event") and hasattr(jpc, "event")
    for pc in (jpc, tpc):
        pc.reset()


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
