"""orb32 frontend of the PyTorch port against the JAX package.

Tolerances and why:
- pyramid: 1e-3 gray levels; JAX runs the resize products at bf16x3
  (~1e-4 gray levels, frontend/pyramid.py:72), the port in fp32;
- blur: 1e-4; the same tap-by-tap sums, fused differently by XLA;
- spread top-k, patch gather: exactly equal on the same input;
- IC angle: 1e-4 rad; a 961-term moment product in another order;
- BRIEF: exactly equal bits on the same patches and angles, except where
  an angle lies within 1e-3 of a rotation-step boundary;
- whole extraction on a rendered frame: >= 99% of valid keypoints equal
  (level, x, y) and >= 99% of those with equal descriptors, since the
  fp32 pyramid moves a few near-threshold FAST decisions.
"""

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
from anyfeature_vslam_tpu_torch.frontend import brief as tbrief
from anyfeature_vslam_tpu_torch.frontend import cuda_fast
from anyfeature_vslam_tpu_torch.frontend import orientation as torient
from anyfeature_vslam_tpu_torch.frontend import pyramid as tpyr
from anyfeature_vslam_tpu_torch.frontend import select as tselect
from anyfeature_vslam_tpu_torch.frontend.extractor import (ExtractorConfig, OrbExtractor,
                                                           SiftExtractor, make_extractor)
from torch_slice_scene import SliceScene

H, W = 240, 320


@pytest.fixture(scope="module")
def frame():
    img8, _ = SliceScene(W, H).render(13)
    return img8.astype(np.float32)


@pytest.fixture(scope="module")
def extractor():
    return OrbExtractor(ExtractorConfig(n_features=500), H, W)


def test_pyramid_matches_jax(frame, extractor):
    want = jpyr.build_pyramid(jnp.asarray(frame), 8, 1.2)
    got = tpyr.build_pyramid(torch.from_numpy(frame), extractor.resize_mats())
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=0)


def test_blur_matches_jax(frame, extractor):
    want = np.asarray(jpyr.gaussian_blur(jnp.asarray(frame), 2.0))
    got = tpyr.gaussian_blur(torch.from_numpy(frame), extractor.gauss).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("level,budget,border", [(0, 96, 16), (2, 66, 16), (5, 300, 8)])
def test_select_spread_topk_equal(frame, level, budget, border):
    lev = jpyr.build_pyramid(jnp.asarray(frame), 8, 1.2)[level]
    score = np.asarray(jfast.nms3x3(jfast.fast_score_map(lev, 20.0)))
    want = jselect.select_spread_topk(jnp.asarray(score), budget, border)
    got = tselect.select_spread_topk(torch.from_numpy(score), budget, border)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < got[2].sum() <= budget


def test_gather_patches_and_ic_angle(frame, extractor):
    rng = np.random.default_rng(0)
    xy = rng.integers(-3, [W + 3, H + 3], (200, 2)).astype(np.float32)  # edges clamp
    want = np.asarray(jorient.gather_patches(jnp.asarray(frame), jnp.asarray(xy), 15))
    got = torient.gather_patches(torch.from_numpy(frame), torch.from_numpy(xy), 15).numpy()
    np.testing.assert_array_equal(got, want)
    flat = want.reshape(200, -1)
    want_ang = np.asarray(jorient.ic_angle_from_patches(jnp.asarray(flat)))
    got_ang = torient.ic_angle_from_patches(torch.from_numpy(flat), extractor.moment_mat).numpy()
    np.testing.assert_allclose(got_ang, want_ang, atol=1e-4, rtol=0)


def test_brief_bits_equal(extractor):
    rng = np.random.default_rng(1)
    n = 400
    flat = rng.uniform(0, 255, (n, 961)).astype(np.float32)
    flat[:50] = np.round(flat[:50] / 32) * 32  # equal pixels: zero differences
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    angle[:20] = (np.arange(20) - 10) * (2 * np.pi / 30)  # exactly on steps
    valid = rng.random(n) < 0.9
    _, want = jbrief.describe_from_flat(jnp.asarray(flat), jnp.asarray(angle), jnp.asarray(valid))
    got = tbrief.describe_from_flat(torch.from_numpy(flat), torch.from_numpy(angle),
                                    torch.from_numpy(valid), extractor.brief_p1,
                                    extractor.brief_p2).numpy()
    steps = angle.astype(np.float64) * 30 / (2 * np.pi)
    near_boundary = np.abs(np.abs(steps - np.floor(steps)) - 0.5) < 1e-3
    same = (got == np.asarray(want)).all(axis=1)
    assert same[~near_boundary].all()
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 1}


def test_extract_features_on_rendered_frame(frame, extractor):
    cfg = jext.ExtractorConfig(n_features=500)
    want = {k: np.asarray(v) for k, v in
            jext.extract_features(jnp.asarray(frame), cfg, H, W).items()}
    got = {k: v.numpy() for k, v in extractor(torch.from_numpy(frame)).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_allclose(got["size"], want["size"], rtol=2e-7)
    np.testing.assert_array_equal(got["octave"], want["octave"])

    def keyed(f):
        keys = zip(f["octave"], f["xy"][:, 0], f["xy"][:, 1])
        return {k: i for i, k in enumerate(keys) if f["valid"][i]}

    kg, kw = keyed(got), keyed(want)
    common = set(kg) & set(kw)
    assert len(kw) > 400
    assert len(common) >= 0.99 * len(kw) and len(common) >= 0.99 * len(kg)
    same_desc = [np.array_equal(got["desc_bits"][kg[k]], want["desc_bits"][kw[k]]) for k in common]
    assert np.mean(same_desc) >= 0.99
    ang = np.array([[got["angle"][kg[k]], want["angle"][kw[k]]] for k in common])
    assert np.median(np.abs(ang[:, 0] - ang[:, 1])) < 1e-4
    assert cuda_fast.fast_nms.launches == 0


@pytest.mark.parametrize("name", ["surf64", "sift128"])
def test_other_families_raise_with_their_roadmap_item(name):
    """Both families are ported: surf64 is the pyramid extractor's (det(H)
    detection, grad64), while sift128's scale space is SiftExtractor's,
    so the pyramid extractor refuses it and make_extractor builds it."""
    cfg = ExtractorConfig.for_feature(name)
    if name == "surf64":
        assert OrbExtractor(cfg, H, W).cfg.detector == "hessian"
    else:
        with pytest.raises(ValueError, match="make_extractor"):
            OrbExtractor(cfg, H, W)
        assert isinstance(make_extractor(cfg, H, W), SiftExtractor)
