"""Kernel K1's plain twin (FAST-9/16 + 3x3 NMS) against the JAX package:
the jnp path and the Pallas kernel in interpret mode. Only float
subtracts, compares and min/max are involved, so all three must be
exactly equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu.frontend import fast as jfast
from anyfeature_vslam_tpu.frontend.pallas_fast import fast_nms_pallas
from anyfeature_vslam_tpu_torch.frontend import cuda_fast
from anyfeature_vslam_tpu_torch.frontend import fast as tfast


def _image(kind, h, w):
    rng = np.random.default_rng(7)
    if kind == "uniform":
        return rng.uniform(0, 255, (h, w)).astype(np.float32)
    if kind == "levels":  # few gray levels: many equal scores, NMS ties
        return (rng.integers(0, 6, (h, w)) * 40.0).astype(np.float32)
    return np.full((h, w), 100.0, np.float32)  # flat: no corner


@pytest.mark.parametrize("kind", ["uniform", "levels", "flat"])
@pytest.mark.parametrize("hw", [(64, 96), (48, 179)])
def test_plain_twin_equals_jax(kind, hw):
    img = _image(kind, *hw)
    want = np.asarray(jfast.nms3x3(jfast.fast_score_map(jnp.asarray(img), 20.0)))
    want_pallas = np.asarray(fast_nms_pallas(jnp.asarray(img), 20.0, interpret=True))
    got = cuda_fast.fast_nms_plain(torch.from_numpy(img), 20.0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_pallas)
    if kind == "flat":
        assert np.count_nonzero(got) == 0
    else:
        assert np.count_nonzero(got) > 0


def test_score_map_equals_jax_before_nms():
    img = _image("uniform", 64, 96)
    want = np.asarray(jfast.fast_score_map(jnp.asarray(img), 20.0))
    got = tfast.fast_score_map(torch.from_numpy(img), 20.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_uses_twin_on_cpu_without_launching():
    img = torch.from_numpy(_image("uniform", 48, 179))
    before = cuda_fast.fast_nms.launches
    out = cuda_fast.fast_nms(img, 20.0)
    assert torch.equal(out, cuda_fast.fast_nms_plain(img, 20.0))
    assert cuda_fast.fast_nms.launches == before == 0


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        cuda_fast.fast_nms(torch.empty((16, 16), device="meta"), 20.0)


@pytest.fixture(scope="module")
def rendered_levels():
    """The 8 pyramid levels (port's pyramid) of frame 13 of the rendered
    benchmark scene at 320x240."""
    from anyfeature_vslam_tpu_torch.frontend import pyramid
    from anyfeature_vslam_tpu_torch.frontend.extractor import ExtractorConfig, OrbExtractor
    from torch_slice_scene import FIRST_TRACKED, SliceScene

    img8 = SliceScene(320, 240).render(FIRST_TRACKED)[0]
    ext = OrbExtractor(ExtractorConfig(n_features=500), 240, 320)
    levels = pyramid.build_pyramid(torch.from_numpy(img8).float(), ext.resize_mats())
    return [l.contiguous() for l in levels]


def test_levels_twin_equals_pallas_on_every_level(rendered_levels):
    got = cuda_fast.fast_nms_levels(rendered_levels, 20.0)
    assert len(got) == 8 and cuda_fast.fast_nms.launches == 0
    for lvl, (lev, score) in enumerate(zip(rendered_levels, got)):
        want = np.asarray(fast_nms_pallas(jnp.asarray(lev.numpy()), 20.0, interpret=True))
        assert score.shape == lev.shape
        np.testing.assert_array_equal(score.numpy(), want, err_msg=f"level {lvl}")
    assert np.count_nonzero(got[0].numpy()) > 0


def test_levels_wrapper_refuses_bad_tables():
    img = torch.zeros((16, 16))
    with pytest.raises(ValueError):
        cuda_fast.fast_nms_levels([], 20.0)
    with pytest.raises(ValueError):
        cuda_fast.fast_nms_levels([img] * (cuda_fast.MAX_LEVELS + 1), 20.0)
    with pytest.raises(ValueError):
        cuda_fast.fast_nms_levels([img, torch.empty((16, 16), device="meta")], 20.0)
