"""The feature families of the PyTorch port beyond orb32 (the FAST
families brisk48, anyfeat_bin, anyfeat_nonbin; the nonlinear families
akaze61, kaze64; the gradient-histogram families surf64, sift128; the
precomputed r2d2_128) against the JAX package, at 320x240 on the rendered
benchmark scene (tests/torch_slice_scene.py). The nonlinear families'
modules are held against JAX's in tests/test_torch_nonlinear.py, the
scale space, blob detectors and gradient histograms in
tests/test_torch_scalespace.py, r2d2_128 in tests/test_torch_r2d2.py.

Tolerances and why:
- copied constants (ring patterns and matrices, the learned48 sampling
  matrix): exactly equal;
- the learned48 MLP carried over by ``learned48_from_numpy``: 1e-5 on unit
  vectors, fp32 products in another order;
- ring orientation: 1e-4 rad, a 1089- or 2025-term fp32 product in another
  order; the rotation step equal except within 1e-4 rad of a step
  boundary;
- ring bits: both sides multiply bf16-rounded operands exactly in fp32 and
  differ only in summation order, so a bit may differ only where JAX's
  picked sum is within 1e-3 of the row's largest |sum| of 0, and >= 99.9%
  of bits are equal;
- learned48 descriptors on the same inputs: 1e-4 (fp32 sums in another
  order through the MLP);
- whole extraction: >= 99% of valid keypoints equal (level, x, y); of
  those, >= 99% with equal bits (binary) or within 1e-4 (float): the port's
  fp32 pyramid differs from JAX's bf16x3 one by ~1e-4 gray levels, which
  moves a few near-threshold FAST decisions and, through the bf16
  rounding of the descriptor operands, a few rows of a level > 0; the
  median angle error < 1e-4 rad. The nonlinear families' extraction is
  held so at JAX's contrast factor: the factor is a 300-bin histogram
  percentile, and on this frame the two packages put it one bin apart
  (tests/test_torch_nonlinear.py says why and holds it within one bin;
  tests/contrast_factor_flips.py prints it per frame);
  at one factor their keypoints and descriptors agree as well;
- surf64's extraction: >= 99% of valid keypoints equal, median angle
  error < 1e-4 rad; at JAX's pyramid >= 99% of rows within 1e-4 (measured
  all within 1e-7); from the port's own pyramid >= 99% of rows within
  1e-3: a level's last-bit difference (the pyramid's products sum in
  another order) flips the bf16 rounding of a gradient operand, which
  moves about 1% of the rows of levels >= 1 by up to 2.8e-4 (measured on
  frames 5, 13, 30);
- sift128's extraction: a keypoint is its unit's integer maximum moved by
  the subpixel offsets of an ill-conditioned 3x3 solve, which magnify the
  blurs' last-bit differences (tests/test_torch_scalespace.py), so
  keypoints are equal when their octaves are equal and they lie within
  0.01 px (measured 2.5e-3 px at most): >= 99% of both sides; of those,
  >= 99% of rows within 1e-4 and median angle error < 1e-4 rad; their
  sizes (the refined scale, through the same offsets) within 1e-4
  relative (measured 6.0e-5 on frames 5, 13, 30);
- K2's float search on real anyfeat_nonbin (D = 48) and sift128
  (D = 128) descriptors: best and second within 1e-5 (squared L2 of unit
  vectors in another order), the index equal wherever best and second
  differ by more than 1e-5.
"""

import contextlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu.frontend import extractor as jext
from anyfeature_vslam_tpu.frontend import graddesc as jgrad
from anyfeature_vslam_tpu.frontend import learned48 as jl48
from anyfeature_vslam_tpu.frontend import orientation as jorient
from anyfeature_vslam_tpu.frontend import pyramid as jpyr
from anyfeature_vslam_tpu.frontend import ringdesc as jring
from anyfeature_vslam_tpu.frontend import select as jselect
from anyfeature_vslam_tpu.frontend import fast as jfast
from anyfeature_vslam_tpu.frontend import nonlinear as jnl
from anyfeature_vslam_tpu.ops import pallas_match as jpm
from anyfeature_vslam_tpu.ops.camera import CameraParams as JaxCamera
from anyfeature_vslam_tpu_torch import convert
from anyfeature_vslam_tpu_torch.frontend import cuda_fast
from anyfeature_vslam_tpu_torch.frontend import extractor as text
from anyfeature_vslam_tpu_torch.frontend import graddesc as tgrad
from anyfeature_vslam_tpu_torch.frontend import learned48 as tl48
from anyfeature_vslam_tpu_torch.frontend import nonlinear as tnl
from anyfeature_vslam_tpu_torch.frontend import orientation as torient
from anyfeature_vslam_tpu_torch.frontend import ringdesc as tring
from anyfeature_vslam_tpu_torch.ops import cuda_match
from anyfeature_vslam_tpu_torch.system import System
from torch_slice_scene import SliceScene

H, W, N_FEATURES = 240, 320, 600
FAMILIES = ("brisk48", "anyfeat_bin", "anyfeat_nonbin")
NONLINEAR = ("akaze61", "kaze64")
GRAD = ("surf64", "sift128")


@contextlib.contextmanager
def one_thread():
    """One torch intra-op thread: the suite's workers share the host's
    cores, and each torch defaults to all of them."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n_threads)


@pytest.fixture(scope="module")
def frame():
    img8, _ = SliceScene(W, H).render(13)
    return img8.astype(np.float32)


def _level_keypoints(frame, level, scale, detect_th, budget):
    """A JAX pyramid level and its spread top-k keypoints (shared inputs)."""
    img_l = jpyr.build_pyramid(jnp.asarray(frame), 8, scale)[level]
    score = jfast.nms3x3(jfast.fast_score_map(img_l, detect_th))
    xy, _, valid = jselect.select_spread_topk(score, budget, 16)
    return np.array(img_l), np.array(xy), np.array(valid)


# ---------------------------------------------------------------- constants

@pytest.mark.parametrize("kind", ["brisk", "freak"])
def test_ring_patterns_and_matrices_equal(kind):
    pattern = tring.brisk_pattern if kind == "brisk" else tring.freak_pattern
    jpattern = jring.brisk_pattern if kind == "brisk" else jring.freak_pattern
    for got, want in zip(pattern(), jpattern()):
        np.testing.assert_array_equal(got, want)
    radius = tring.PATCH_RADIUS[kind]
    assert radius == jring.PATCH_RADIUS[kind] and tring.N_BITS[kind] == jring.N_BITS[kind]
    assert tring.N_ROT == jring.N_ROT
    for got, want in zip(tring._ring_matrices(kind, radius), jring._ring_matrices(kind, radius)):
        np.testing.assert_array_equal(got, want)


def test_learned48_sampling_matrix_equal():
    np.testing.assert_array_equal(tgrad._sample_matrix(), jgrad._sample_mat())
    for name in ("PATCH", "N_ROT", "PATCH_RADIUS", "_P", "_N_SAMP"):
        assert getattr(tgrad, name) == getattr(jgrad, name), name
    gx, gy = tgrad._grid()
    np.testing.assert_array_equal(gx, jgrad._GX)
    np.testing.assert_array_equal(gy, jgrad._GY)


def test_learned48_from_numpy_matches_jax_mlp():
    params = jl48.load_weights()
    assert params is not None
    for k, v in tl48.load_weights().items():
        np.testing.assert_array_equal(v, params[k])
    mlp = convert.learned48_from_numpy(params, "cpu")
    x = np.random.default_rng(0).normal(size=(64, 400)).astype(np.float32)
    want = np.asarray(jl48.mlp_forward({k: jnp.asarray(v) for k, v in params.items()},
                                       jnp.asarray(x)))
    got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_learned48_weights_file_is_required(tmp_path):
    with pytest.raises(FileNotFoundError):
        tl48.load_weights(str(tmp_path / "missing.npz"))


# ------------------------------------------------------------- descriptors

@pytest.mark.parametrize("kind,scale,detect_th", [("brisk", 1.5, 34.0), ("freak", 1.2, 20.0)])
def test_describe_ring_matches_jax(frame, kind, scale, detect_th):
    img_l, xy, valid = _level_keypoints(frame, 1, scale, detect_th, 300)
    assert valid.sum() > 150
    want_ang, want_bits = (np.asarray(a) for a in jring.describe_ring(
        jnp.asarray(img_l), jnp.asarray(xy), jnp.asarray(valid), kind))
    desc_m, ori_m = tring.ring_tensors(kind)
    got_ang, got_bits = (a.numpy() for a in tring.describe_ring(
        torch.from_numpy(img_l), torch.from_numpy(xy), torch.from_numpy(valid), kind,
        desc_m, ori_m))
    np.testing.assert_allclose(got_ang, want_ang, atol=1e-4, rtol=0)
    # the rotation step, and JAX's picked sums (its own expressions)
    steps = want_ang.astype(np.float64) * tring.N_ROT / (2 * np.pi)
    near = np.abs(np.abs(steps - np.floor(steps)) - 0.5) * (2 * np.pi / tring.N_ROT) < 1e-4
    got_step = tring.rotation_step(torch.from_numpy(got_ang)).numpy()
    want_step = np.round(want_ang * np.float32(tring.N_ROT / (2 * np.pi))).astype(np.int64) % 16
    assert (got_step == want_step)[~near].all()
    radius, n_bits = tring.PATCH_RADIUS[kind], tring.N_BITS[kind]
    flat = np.asarray(jorient.gather_patches(jnp.asarray(img_l), jnp.asarray(xy), radius))
    flat = flat.reshape(len(xy), -1)
    dm, _ = jring._ring_matrices(kind, radius)
    diffs = np.asarray(jnp.dot(jnp.asarray(flat, jnp.bfloat16), jnp.asarray(dm, jnp.bfloat16),
                               preferred_element_type=jnp.float32))
    picked = diffs.reshape(len(xy), tring.N_ROT, n_bits)[np.arange(len(xy)), want_step]
    np.testing.assert_array_equal((picked > 0) & valid[:, None], want_bits.astype(bool))
    same = got_bits == want_bits
    assert same.mean() >= 0.999 and same[~valid].all()
    rows = ~near & valid
    row_max = np.abs(picked).max(axis=1, keepdims=True)
    assert (np.abs(picked) < 1e-3 * row_max)[rows][~same[rows]].all()
    assert got_bits.dtype == np.uint8 and set(np.unique(got_bits)) <= {0, 1}


def test_ic_angle_and_describe_learned48_match_jax(frame):
    img_l, xy, valid = _level_keypoints(frame, 0, 1.2, 20.0, 300)
    want_ang = np.asarray(jorient.ic_angle(jnp.asarray(img_l), jnp.asarray(xy)))
    mm = torch.from_numpy(torient.moment_matrix_np())
    got_ang = torient.ic_angle(torch.from_numpy(img_l), torch.from_numpy(xy), mm).numpy()
    np.testing.assert_allclose(got_ang, want_ang, atol=1e-4, rtol=0)
    want = np.asarray(jl48.describe_learned48(jnp.asarray(img_l), jnp.asarray(xy),
                                              jnp.asarray(want_ang), jnp.asarray(valid)))
    mlp = convert.learned48_from_numpy(tl48.load_weights(), "cpu")
    got = tl48.describe_learned48(torch.from_numpy(img_l), torch.from_numpy(xy),
                                  torch.from_numpy(want_ang), torch.from_numpy(valid),
                                  tgrad.sample_tensor(), mlp).numpy()
    assert got.dtype == np.float32 and got.shape == (len(xy), 48)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (got[~valid] == 0).all()


@pytest.mark.parametrize("name", FAMILIES + NONLINEAR)
def test_extract_features_matches_jax(frame, name, monkeypatch):
    jcfg = jext.ExtractorConfig.for_feature(name, N_FEATURES)
    want = {k: np.asarray(v) for k, v in
            jext.extract_features(jnp.asarray(frame), jcfg, H, W).items()}
    ext = text.make_extractor(text.ExtractorConfig.for_feature(name, N_FEATURES), H, W)
    if name in NONLINEAR:
        # the port's scale space at JAX's contrast factor (module docstring)
        k_jax = float(jnl.contrast_factor(jnp.asarray(frame) * jnp.float32(1.0 / 255.0)))
        monkeypatch.setattr(tnl, "contrast_factor", lambda img01, taps: torch.tensor(k_jax))
    assert isinstance(ext, text.NonlinearExtractor if name in NONLINEAR
                      else text.FeatureExtractor)
    got = {k: v.numpy() for k, v in ext(torch.from_numpy(frame)).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert got["desc_bits"].dtype == text.descriptor_dtype(jcfg.descriptor)
    np.testing.assert_allclose(got["size"], want["size"], rtol=2e-7)
    np.testing.assert_array_equal(got["octave"], want["octave"])

    def keyed(f):
        keys = zip(f["octave"], f["xy"][:, 0], f["xy"][:, 1])
        return {k: i for i, k in enumerate(keys) if f["valid"][i]}

    kg, kw = keyed(got), keyed(want)
    common = sorted(set(kg) & set(kw))
    assert len(kw) > 400
    assert len(common) >= 0.99 * len(kw) and len(common) >= 0.99 * len(kg)
    dg = got["desc_bits"][[kg[k] for k in common]]
    dw = want["desc_bits"][[kw[k] for k in common]]
    if dw.dtype == np.uint8:
        same = (dg == dw).all(axis=1)
    else:
        same = np.abs(dg - dw).max(axis=1) <= 1e-4
    assert same.mean() >= 0.99
    ang = np.array([[got["angle"][kg[k]], want["angle"][kw[k]]] for k in common])
    assert np.median(np.abs(ang[:, 0] - ang[:, 1])) < 1e-4
    assert cuda_fast.fast_nms.launches == 0


def _keyed(f):
    keys = zip(f["octave"], f["xy"][:, 0], f["xy"][:, 1])
    return {k: i for i, k in enumerate(keys) if f["valid"][i]}


def _sift_pairs(got, want, tol=0.01):
    """(got slot, want slot) of the valid keypoints with equal octaves
    within tol px of each other (the nearest, each used once)."""
    pairs, used = [], set()
    gv = np.nonzero(got["valid"])[0]
    for j in np.nonzero(want["valid"])[0]:
        cand = gv[got["octave"][gv] == want["octave"][j]]
        if not len(cand):
            continue
        d = np.abs(got["xy"][cand] - want["xy"][j]).max(axis=1)
        k = int(np.argmin(d))
        if d[k] <= tol and int(cand[k]) not in used:
            used.add(int(cand[k]))
            pairs.append((int(cand[k]), int(j)))
    return np.array(pairs)


@pytest.mark.parametrize("name", GRAD)
def test_grad_family_extraction_matches_jax(frame, name):
    """surf64 (det(H) pyramid, grad64) and sift128 (DoG scale space,
    grad128 with SIFT's orientation) against ``extract_features``
    (tolerances in the module docstring)."""
    jcfg = jext.ExtractorConfig.for_feature(name, N_FEATURES)
    want = {k: np.asarray(v) for k, v in
            jext.extract_features(jnp.asarray(frame), jcfg, H, W).items()}
    ext = text.make_extractor(text.ExtractorConfig.for_feature(name, N_FEATURES), H, W)
    assert isinstance(ext, text.SiftExtractor if name == "sift128" else text.FeatureExtractor)
    with one_thread():
        got = {k: v.numpy() for k, v in ext(torch.from_numpy(frame)).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["octave"], want["octave"])
    n_got, n_want = int(got["valid"].sum()), int(want["valid"].sum())
    assert n_want > (400 if name == "surf64" else 200)
    if name == "surf64":
        np.testing.assert_allclose(got["size"], want["size"], rtol=2e-7)
        # at JAX's pyramid: detection and description alone
        levels = [torch.from_numpy(np.array(l)) for l in
                  jpyr.build_pyramid(jnp.asarray(frame), jcfg.n_levels, jcfg.scale_factor)]
        with one_thread():
            at_jax = {k: v.numpy() for k, v in ext.from_levels(levels).items()}
        results = ((got, 1e-3), (at_jax, 1e-4))
    else:
        results = ((got, 1e-4),)
    for res, row_tol in results:
        if name == "surf64":
            kg, kw = _keyed(res), _keyed(want)
            common = sorted(set(kg) & set(kw))
            pairs = np.array([(kg[k], kw[k]) for k in common])
        else:
            pairs = _sift_pairs(res, want)
        assert len(pairs) >= 0.99 * n_want and len(pairs) >= 0.99 * n_got
        row_err = np.abs(res["desc_bits"][pairs[:, 0]] - want["desc_bits"][pairs[:, 1]]).max(1)
        assert (row_err <= row_tol).mean() >= 0.99
        ang_err = np.abs(res["angle"][pairs[:, 0]] - want["angle"][pairs[:, 1]])
        assert np.median(ang_err) < 1e-4
        if name == "sift128":
            rel = np.abs(res["size"][pairs[:, 0]] / want["size"][pairs[:, 1]] - 1.0)
            assert rel.max() <= 1e-4
    assert cuda_fast.fast_nms.launches == 0


# ------------------------------------------------------------ K2 float twin

def _float_twin_case(fa, fb, min_matched=300):
    """K2's plain twin against the Pallas kernel (interpret mode) on the
    float descriptors of two frames' features, with the window and size
    gates of a guided search."""
    q, c = fa["desc_bits"].numpy(), fb["desc_bits"].numpy()
    rng = np.random.default_rng(5)
    q_uv = fa["xy"].numpy() + rng.normal(0, 2, fa["xy"].shape).astype(np.float32)
    q_rad = np.where(fa["valid"].numpy(), 15.0, -1.0).astype(np.float32)
    size = fa["size"].numpy()
    args = [q, c, q_uv, fb["xy"].numpy(), q_rad, size / 1.5, size * 1.5, fb["size"].numpy(),
            fb["valid"].numpy()]
    jargs = list(map(jnp.asarray, args))
    want = [np.asarray(o) for o in jpm.fused_best_two(*jargs, tile_q=128, tile_c=256,
                                                       interpret=True)]
    got = [t.numpy() for t in cuda_match.best_two(*map(torch.from_numpy, args))]
    b, i, s = got
    wb, wi, ws = want
    assert (wi >= 0).sum() > min_matched
    np.testing.assert_allclose(b, wb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(s, ws, atol=1e-5, rtol=0)
    clear = (ws - wb) > 1e-5
    np.testing.assert_array_equal(i[clear], wi[clear])
    assert cuda_match.best_two.launches == 0


def _float_pair(frame, name):
    ext = text.make_extractor(text.ExtractorConfig.for_feature(name, N_FEATURES), H, W)
    with one_thread():
        return (ext(torch.from_numpy(frame)),
                ext(torch.from_numpy(SliceScene(W, H).render(15)[0].astype(np.float32))))


def test_float_search_twin_matches_pallas_on_learned48(frame):
    """D = 48: anyfeat_nonbin descriptors of frames 13 and 15."""
    fa, fb = _float_pair(frame, "anyfeat_nonbin")
    assert fa["desc_bits"].shape[1] == 48
    _float_twin_case(fa, fb)


def test_float_search_twin_matches_pallas_on_sift128(frame):
    """D = 128: sift128 descriptors of frames 13 and 15."""
    fa, fb = _float_pair(frame, "sift128")
    assert fa["desc_bits"].shape[1] == 128
    _float_twin_case(fa, fb, min_matched=100)


# ------------------------------------------------------------- the System

@pytest.mark.parametrize("name", FAMILIES)
def test_system_builds_each_fast_family(name):
    sc = SliceScene(160, 120, n_frames=2)
    system = System(JaxCamera.create(**sc.camera), feature=name, device="cpu")
    desc = jext.FEATURE_REGISTRY[name][1]
    assert system.map.desc_dtype == text.descriptor_dtype(desc) == jext.descriptor_dtype(desc)
    assert system.map.kf_desc_bits.dtype == system.map.pt_desc_bits.dtype == system.map.desc_dtype
    assert system.map.desc_dim == jext.descriptor_dim(desc)
    assert system.tracker.extractor.cfg.descriptor == desc
    assert system.tracker.extractor_init.cfg.n_features == 2 * system.tracker.extractor.cfg.n_features
    assert system.vocabulary is not None and system.loop_closer is not None
    assert system.vocabulary.centroids[-1].dtype == system.map.desc_dtype


@pytest.mark.parametrize("name", NONLINEAR)
def test_system_builds_each_nonlinear_family(name):
    """akaze61 (488 bits) and kaze64 (64-d floats): the nonlinear extractor
    for both of the tracker's extractors, with their shared level scales."""
    sc = SliceScene(160, 120, n_frames=2)
    system = System(JaxCamera.create(**sc.camera), feature=name, device="cpu")
    desc = jext.FEATURE_REGISTRY[name][1]
    assert system.map.desc_dtype == text.descriptor_dtype(desc) == jext.descriptor_dtype(desc)
    assert system.map.kf_desc_bits.dtype == system.map.pt_desc_bits.dtype == system.map.desc_dtype
    assert system.map.desc_dim == jext.descriptor_dim(desc) == (488 if name == "akaze61" else 64)
    for ext in (system.tracker.extractor, system.tracker.extractor_init):
        assert isinstance(ext, text.NonlinearExtractor) and ext.cfg.descriptor == desc
        assert len(set(ext.level_key)) == 4
    assert system.tracker.extractor_init.cfg.n_features == 2 * system.tracker.extractor.cfg.n_features
    assert system.vocabulary is not None and system.loop_closer is not None
    assert system.vocabulary.centroids[-1].dtype == system.map.desc_dtype
    feats = system.tracker.extractor(torch.from_numpy(sc.render(0)[0].astype(np.float32)))
    assert feats["desc_bits"].shape == (system.tracker.extractor.cfg.capacity, system.map.desc_dim)
    assert set(feats["octave"].tolist()) == {0, 1}


@pytest.mark.parametrize("name", ["sift128", "surf64", "r2d2_128"])
def test_other_families_still_raise(name):
    """The last three families no longer raise: each System builds with
    the map and extractors of its family (r2d2_128 loads its features and
    has none; it has no shipped vocabulary and trains one online, as the
    JAX System does)."""
    sc = SliceScene(160, 120, n_frames=2)
    system = System(JaxCamera.create(**sc.camera), feature=name, device="cpu")
    desc = jext.FEATURE_REGISTRY[name][1]
    assert np.dtype(system.map.desc_dtype) == np.float32 == jext.descriptor_dtype(desc)
    assert system.map.desc_dim == jext.descriptor_dim(desc)
    want = {"sift128": text.SiftExtractor, "surf64": text.FeatureExtractor,
            "r2d2_128": type(None)}[name]
    for ext in (system.tracker.extractor, system.tracker.extractor_init):
        assert isinstance(ext, want)
    if name == "r2d2_128":
        assert system.tracker.precomputed and system.vocabulary is None
        assert system.map.n_feat == system.tracker.ext_cfg.capacity
    else:
        assert system.vocabulary is not None and system.loop_closer is not None
        feats = system.tracker.extractor(torch.from_numpy(sc.render(0)[0].astype(np.float32)))
        assert feats["desc_bits"].shape == (system.map.n_feat, system.map.desc_dim)


def test_run_mono_takes_a_family(tmp_path, monkeypatch):
    """``run_mono feature:anyfeat_nonbin device:cpu`` reaches the System:
    the CLI over 8 rendered frames builds a float32 48-d map and tracks."""
    from anyfeature_vslam_tpu_torch import run_mono
    from anyfeature_vslam_tpu_torch import system as tsystem
    from test_torch_system import _write_sequence

    built = []

    class Recording(tsystem.System):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(tsystem, "System", Recording)
    seq, out = str(tmp_path / "seq"), str(tmp_path / "out")
    _write_sequence(seq, SliceScene(W, H), 8)
    with one_thread():
        assert run_mono.main([f"sequence_path:{seq}", f"exp_folder:{out}", "exp_id:t",
                              "feature:anyfeat_nonbin", f"n_features:{N_FEATURES}",
                              "verbose:0", "device:cpu"]) == 0
    (system,) = built
    assert np.dtype(system.map.desc_dtype) == np.float32 and system.map.desc_dim == 48
    assert system.tracker.stats["tracked_frames"] >= 6 and system.map.n_keyframes() >= 3


def test_run_mono_takes_a_nonlinear_family(tmp_path, monkeypatch):
    """``run_mono feature:akaze61 device:cpu`` reaches the System: the CLI
    over 8 rendered frames builds a 488-bit map and tracks."""
    from anyfeature_vslam_tpu_torch import run_mono
    from anyfeature_vslam_tpu_torch import system as tsystem
    from test_torch_system import _write_sequence

    built = []

    class Recording(tsystem.System):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(tsystem, "System", Recording)
    seq, out = str(tmp_path / "seq"), str(tmp_path / "out")
    _write_sequence(seq, SliceScene(W, H), 8)
    with one_thread():
        assert run_mono.main([f"sequence_path:{seq}", f"exp_folder:{out}", "exp_id:t",
                              "feature:akaze61", f"n_features:{N_FEATURES}", "verbose:0",
                              "device:cpu"]) == 0
    (system,) = built
    assert np.dtype(system.map.desc_dtype) == np.uint8 and system.map.desc_dim == 488
    assert isinstance(system.tracker.extractor, text.NonlinearExtractor)
    assert system.tracker.stats["tracked_frames"] >= 6 and system.map.n_keyframes() >= 3
