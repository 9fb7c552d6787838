"""The nonlinear scale space (FED diffusion, det(H) detection) and the
M-LDB / M-SURF descriptors of the PyTorch port against the JAX package,
at 320x240 on images made from a numpy seed (a 16-px random block field
with Gaussian noise, so no gradient is exactly zero) and on a rendered
frame of the benchmark scene.

Tolerances and why:
- the contrast factor on the seeded image: equal to 1e-6 relative (the
  same bin of the 300-bin histogram; the maximum gradient magnitude may
  differ in its last bit). On the rendered frame within one bin: the
  scene has dithered symmetric spots whose smoothed gradient is exactly
  0 in the port's blur but a few 1e-8 in JAX's fused XLA loop (which
  rounds the tap sums in another way), and those count toward the
  histogram's total (tests/contrast_factor_flips.py prints them per
  frame);
- the scale space, level by level: L, Lx, Ly within 2e-5 and det(H)
  within 1e-5 of the level's largest |det(H)|: fp32 elementwise chains
  rounded in another order by XLA's fusion, the octave halving's fp32
  products summed in another order, and 32 FED steps (KAZE) carrying
  both;
- detection on JAX's own levels: the same maps above the threshold,
  values within 1e-6 relative (3x3 NMS and the cross-level resampling);
- descriptors on JAX's own levels and keypoints: both sides multiply
  bf16-rounded operands exactly in fp32 and differ only in summation
  order, so >= 99% of binary rows equal, >= 99% of float rows within
  1e-4, median angle error < 1e-4 rad.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu.frontend import mldb as jmldb
from anyfeature_vslam_tpu.frontend import msurf as jmsurf
from anyfeature_vslam_tpu.frontend import nonlinear as jnl
from anyfeature_vslam_tpu.frontend import pyramid as jpyr
from anyfeature_vslam_tpu.frontend import select as jselect
from anyfeature_vslam_tpu_torch.frontend import mldb as tmldb
from anyfeature_vslam_tpu_torch.frontend import msurf as tmsurf
from anyfeature_vslam_tpu_torch.frontend import nonlinear as tnl
from torch_slice_scene import SliceScene

H, W = 240, 320
DETECT_TH = 1e-5  # akaze61 / kaze64 detectionTh
BUDGET = 200


def seeded_image(seed):
    rng = np.random.default_rng(seed)
    blocks = rng.random((H // 16, W // 16)).astype(np.float32)
    img = np.kron(blocks, np.ones((16, 16), np.float32))
    img = img + rng.normal(0, 0.02, (H, W)).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def image():
    return seeded_image(0)


@pytest.fixture(scope="module", params=[True, False], ids=["akaze", "kaze"])
def spaces(request, image):
    """(downsample, JAX levels, port levels from the image, port levels
    holding JAX's arrays, the port's constants)."""
    ds = request.param
    jl = jnl.build_evolution(jnp.asarray(image), 8, downsample=ds)
    consts = tnl.Constants(H, W, 8, ds)
    tl = tnl.build_evolution(torch.from_numpy(image), consts)
    as_port = [tnl.EvolutionLevel(
        octave=a.octave, sublevel=a.sublevel, index=a.index, sigma=a.sigma,
        sigma_rel=a.sigma_rel, **{n: torch.from_numpy(np.array(getattr(a, n)))
                                  for n in ("L", "Lx", "Ly", "response")}) for a in jl]
    return ds, jl, tl, as_port, consts


def _bin_width(img01):
    """The contrast histogram's bin width, from JAX's gradient magnitudes."""
    smooth = jpyr.gaussian_blur(jnp.asarray(img01), 1.0, radius=2)
    gx = 0.5 * (jnl._shift(smooth, 0, 1) - jnl._shift(smooth, 0, -1))
    gy = 0.5 * (jnl._shift(smooth, 1, 0) - jnl._shift(smooth, -1, 0))
    mag = np.sqrt(np.asarray(gx * gx + gy * gy))[1:-1, 1:-1]
    return float(mag.max()) / jnl.K_NBINS


def test_contrast_factor_matches_jax(image):
    taps = tnl.Constants(H, W).smooth
    want = float(jnl.contrast_factor(jnp.asarray(image)))
    got = tnl.contrast_factor(torch.from_numpy(image), taps)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # the rendered scene: within one histogram bin
    frame = SliceScene(W, H).render(13)[0].astype(np.float32) * np.float32(1.0 / 255.0)
    want = float(jnl.contrast_factor(jnp.asarray(frame)))
    got = float(tnl.contrast_factor(torch.from_numpy(frame), taps))
    assert abs(got - want) <= 1.001 * _bin_width(frame), (got, want)


def test_shift_and_scharr_match_jax(image):
    x = torch.from_numpy(image)
    for dy, dx in ((0, 1), (0, -3), (2, 0), (-1, 0), (1, -2)):
        np.testing.assert_array_equal(tnl._shift(x, dy, dx).numpy(),
                                      np.asarray(jnl._shift(jnp.asarray(image), dy, dx)))
    for step in (1, 2, 3):
        for tf, jf in ((tnl.scharr_x, jnl.scharr_x), (tnl.scharr_y, jnl.scharr_y)):
            np.testing.assert_allclose(tf(x, step).numpy(), np.asarray(jf(jnp.asarray(image), step)),
                                       atol=1e-6, rtol=0)


def test_build_evolution_matches_jax(spaces):
    ds, jl, tl, _, consts = spaces
    assert len(tl) == len(jl) == len(consts.plans) == 8
    for a, b in zip(jl, tl):
        assert (b.octave, b.sublevel, b.index) == (a.octave, a.sublevel, a.index)
        assert b.sigma == a.sigma and b.sigma_rel == a.sigma_rel
        for name in ("L", "Lx", "Ly"):
            got, want = getattr(b, name).numpy(), np.asarray(getattr(a, name))
            assert got.shape == want.shape and got.dtype == np.float32, name
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0, err_msg=f"{a.index} {name}")
        want = np.asarray(a.response)
        np.testing.assert_allclose(b.response.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=f"{a.index}")
    shapes = {tuple(b.L.shape) for b in tl}
    assert shapes == ({(H, W), (H // 2, W // 2)} if ds else {(H, W)})


def test_detect_scores_match_jax(spaces):
    _, jl, _, as_port, consts = spaces
    want = [np.asarray(s) for s in jnl.detect_scores(jl)]
    got = [s.numpy() for s in tnl.detect_scores(as_port, consts)]
    n_det = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g > DETECT_TH, w > DETECT_TH)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        n_det += int((w > DETECT_TH).sum())
    assert n_det > 500


def test_descriptors_match_jax_on_jax_levels(spaces):
    """describe_mldb (akaze) / describe_kaze (kaze) per level, on JAX's own
    levels and spread top-k keypoints."""
    ds, jl, _, _, _ = spaces
    pairs = tmldb.pair_indices()
    cell_w = tmsurf.cell_weight_tensor()
    same, ang_err, n_valid = [], [], 0
    for lv, score in zip(jl, jnl.detect_scores(jl)):
        score = jnp.where(score > DETECT_TH, score, 0.0)
        xy, _, valid = jselect.select_spread_topk(score, BUDGET, 8)
        t = [torch.from_numpy(np.array(a)) for a in (lv.L, lv.Lx, lv.Ly, xy, valid)]
        if ds:
            want_ang, want = jmldb.describe_mldb(lv.L, lv.Lx, lv.Ly, xy, valid, lv.sigma_rel)
            got_ang, got = tmldb.describe_mldb(*t, lv.sigma_rel, *tmldb.tensors(lv.sigma_rel),
                                               pairs)
            assert got.dtype == torch.uint8 and got.shape == (BUDGET, tmldb.N_BITS_PADDED)
            assert set(np.unique(got.numpy())) <= {0, 1} and (got[:, tmldb.N_BITS:] == 0).all()
            same.append((got.numpy() == np.asarray(want)).all(axis=1))
        else:
            want_ang, want = jmsurf.describe_kaze(lv.Lx, lv.Ly, xy, valid, lv.sigma_rel)
            got_ang, got = tmsurf.describe_kaze(t[1], t[2], t[3], t[4], lv.sigma_rel,
                                                *tmsurf.tensors(lv.sigma_rel), cell_w)
            assert got.dtype == torch.float32 and got.shape == (BUDGET, 64)
            norms = np.linalg.norm(got.numpy()[np.asarray(valid)], axis=1)
            np.testing.assert_allclose(norms, 1.0, atol=1e-5)
            same.append(np.abs(got.numpy() - np.asarray(want)).max(axis=1) <= 1e-4)
        v = np.asarray(valid)
        assert (got.numpy()[~v] == 0).all()
        same[-1] = same[-1][v]
        ang_err.append(np.abs(got_ang.numpy() - np.asarray(want_ang))[v])
        n_valid += int(v.sum())
    assert n_valid > 500
    assert np.concatenate(same).mean() >= 0.99
    assert np.median(np.concatenate(ang_err)) < 1e-4
