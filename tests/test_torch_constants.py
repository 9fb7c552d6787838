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
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'PIL', 'anyfeature_vslam_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
