"""The port's SIFT scale space, blob detectors and gradient-histogram
descriptors (frontend/scalespace.py, dog.py, graddesc.py) against the JAX
package, at 320x240 on the rendered benchmark scene
(tests/torch_slice_scene.py), inputs shared where a test holds one stage.

Tolerances and why:
- ``dog_extrema_maps`` on the same three DoG slices: exactly equal (score
  and the three offsets): every step is elementwise in JAX's expression
  order;
- the Gaussian blur: JAX's jitted blur rounds differently from the
  port's tap-by-tap sum in about a third of the pixels, by an ulp or two
  (measured 4.6e-5 gray levels at most), so ``build_octave`` is held to
  1e-4 gray levels; ``downsample2``'s products sum in another order
  (1.5e-5 measured): 1e-4;
- ``det_hessian_map``: second differences of those blurs, within 2e-5 of
  the map's largest |response| (4.7e-6 measured);
- ``dog_score_map``: the threshold and NMS decisions may flip where the
  blurs' ulps meet a threshold or a neighbour (0 / 3 / 3 of 1077 / 1735 /
  2436 hessian / dog / dog_norm maxima measured): at most 0.5% of JAX's
  maxima flip, and where both keep a maximum the values agree within
  2e-5 of the map's largest;
- ``describe_grad`` on shared keypoints and angles: 1e-4 at dim 48 and
  64 (measured 1e-7: the bf16-rounded operands are exact in fp32, only
  the summation order differs). At dim 128 each sample falls into one of
  8 orientation bins whose edges lie on the axes and diagonals, and on a
  rendered pyramid level many gradients point exactly along a diagonal
  (|dx| = |dy|), where JAX's float32 atan2 (its own approximation) and
  the port's (float64, rounded) land on either side of the edge: >= 95%
  of rows within 1e-4 (measured 95.3-99.0% on level 2 of frames 5, 13 and
  30; the rows on the scale-space slices sift128 describes agree in
  full, tests/test_torch_families.py);
- ``describe_grad_auto``: the dominant orientation is the argmax of a
  smoothed 36-bin histogram, so a near-tie may pick another peak: >= 99%
  of angles within 1e-4 rad and median < 1e-5 rad; rows >= 99% within
  1e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu.frontend import dog as jdog
from anyfeature_vslam_tpu.frontend import graddesc as jgrad
from anyfeature_vslam_tpu.frontend import orientation as jorient
from anyfeature_vslam_tpu.frontend import pyramid as jpyr
from anyfeature_vslam_tpu.frontend import scalespace as jss
from anyfeature_vslam_tpu.frontend import select as jselect
from anyfeature_vslam_tpu_torch.frontend import dog as tdog
from anyfeature_vslam_tpu_torch.frontend import graddesc as tgrad
from anyfeature_vslam_tpu_torch.frontend import pyramid as tpyr
from anyfeature_vslam_tpu_torch.frontend import scalespace as tss
from torch_slice_scene import SliceScene

H, W = 240, 320
THRESHOLDS = {"hessian": 100.0, "dog": 10.0, "dog_norm": 5e-4}


@pytest.fixture(scope="module")
def frame():
    return SliceScene(W, H).render(13)[0].astype(np.float32)


@pytest.fixture(scope="module")
def jax_octave(frame):
    """JAX's base (the frame blurred to sigma0) and its first octave."""
    inc0 = tss.base_sigma()
    base = jpyr.gaussian_blur(jnp.asarray(frame), inc0, radius=tss.blur_radius(inc0))
    return np.asarray(base), [np.asarray(s) for s in jss.build_octave(base, 2)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mode", tdog.MODES)
def test_dog_score_map_matches_jax(frame, mode):
    th = THRESHOLDS[mode]
    want = np.asarray(jdog.dog_score_map(jnp.asarray(frame), th, mode=mode))
    got = tdog.dog_score_map(_t(frame), th, mode, tdog.tensors(mode)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    n_want = int((want > 0).sum())
    assert n_want > 500
    assert int(((got > 0) != (want > 0)).sum()) <= 0.005 * n_want
    both = (got > 0) & (want > 0)
    assert np.abs(got - want)[both].max() <= 2e-5 * np.abs(want).max()


def test_det_hessian_map_matches_jax(frame):
    want = np.asarray(jss.det_hessian_map(jnp.asarray(frame), 2.0))
    got = tss.det_hessian_map(_t(frame), tss.taps(2.0), 2.0).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def test_build_octave_matches_jax(jax_octave):
    base, want = jax_octave
    inc = [tss.taps(s) for s in tss.increment_sigmas(2)]
    got = tss.build_octave(_t(base), inc)
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0)


def test_downsample2_matches_jax(frame):
    want = np.asarray(jss.downsample2(jnp.asarray(frame)))
    h2, w2 = tss.octave_shape(H, W)
    got = tss.downsample2(_t(frame), _t(tpyr.resize_weights_np(H, h2)),
                          _t(tpyr.resize_weights_np(W, w2))).numpy()
    assert got.shape == want.shape == (H // 2, W // 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("inner", [1, 2])
def test_dog_extrema_maps_matches_jax(jax_octave, inner):
    _, slices = jax_octave
    dogs = [slices[i + 1] - slices[i] for i in range(4)]
    args = dogs[inner - 1:inner + 2]
    want = [np.asarray(a) for a in jss.dog_extrema_maps(*map(jnp.asarray, args), 2.55)]
    got = [a.numpy() for a in tss.dog_extrema_maps(*map(_t, args), 2.55)]
    assert int((want[0] > 0).sum()) > 50
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _keypoints(img, budget=300):
    """JAX det(H) maxima of a level and their spread top-k (shared inputs)."""
    score = jdog.dog_score_map(jnp.asarray(img), 100.0, mode="hessian")
    xy, _, valid = jselect.select_spread_topk(score, budget, 16)
    return np.asarray(xy), np.asarray(valid)


@pytest.mark.parametrize("dim", [48, 64, 128])
def test_describe_grad_matches_jax(frame, dim):
    level = np.asarray(jpyr.build_pyramid(jnp.asarray(frame), 3, 1.2)[2])
    xy, valid = _keypoints(level)
    angle = np.asarray(jorient.ic_angle(jnp.asarray(level), jnp.asarray(xy)))
    want = np.asarray(jgrad.describe_grad(jnp.asarray(level), jnp.asarray(xy), jnp.asarray(angle),
                                          jnp.asarray(valid), dim=dim))
    sample_m, cell_m, rot_cs, _ = tgrad.tensors()
    got = tgrad.describe_grad(_t(level), _t(xy), _t(angle), _t(valid), dim, sample_m,
                              cell_m, rot_cs).numpy()
    assert got.shape == want.shape == (len(xy), dim) and got.dtype == np.float32
    assert valid.sum() > 100
    if dim == 128:
        assert (np.abs(got - want).max(axis=1)[valid] <= 1e-4).mean() >= 0.95
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (got[~valid] == 0).all()


def test_describe_grad_auto_matches_jax(jax_octave):
    """SIFT's dominant orientation and 128-d rows on an octave's slice, at
    keypoints moved by subpixel offsets (as the sift extractor does)."""
    _, slices = jax_octave
    img = slices[1]
    xy, valid = _keypoints(img)
    xy = (xy + np.random.default_rng(3).uniform(-0.6, 0.6, xy.shape)).astype(np.float32)
    wa, wd = (np.asarray(a) for a in jgrad.describe_grad_auto(
        jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid), dim=128))
    ga, gd = (a.numpy() for a in tgrad.describe_grad_auto(_t(img), _t(xy), _t(valid), 128,
                                                          *tgrad.tensors()))
    assert valid.sum() > 100
    ang_err = np.abs(ga - wa)[valid]
    assert (ang_err <= 1e-4).mean() >= 0.99 and np.median(ang_err) < 1e-5
    row_err = np.abs(gd - wd).max(axis=1)[valid]
    assert (row_err <= 1e-4).mean() >= 0.99
    assert (gd[~valid] == 0).all()
