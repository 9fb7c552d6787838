"""The port's host runtime (anyfeature_vslam_tpu_torch/native.py and
csrc/slam_native.cpp) on the CPU.

- The compiled PNG unfilter equals its plain twin (io/png.unfilter_plain)
  byte for byte on seeded rows of every filter type at 1-8 bytes per
  pixel, and whole files decode as PIL decodes them.
- FrameLoader: JAX's loader scenario (tests/test_native.py), close()
  mid-stream, a corrupt frame that raises in get(i) with its path.
- The map kernels equal the port's numpy twins exactly (integers and
  floats alike: the library is built with -ffp-contract=off and keeps the
  twins' order of operations) and the JAX package's native library:
  integers exactly, floats within 5e-7 relative or absolute, a few
  float32 ulps (JAX's library is built with -march=native, where GCC
  contracts a * b + c into an FMA; the differences measured here are at
  most 2.5e-7 relative and 1.8e-7 absolute).
- No fallback: a missing compiler raises; the file builds the library
  itself into a fresh folder.
"""

import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from anyfeature_vslam_tpu import native as jnative
from anyfeature_vslam_tpu_torch import cuda_build, native
from anyfeature_vslam_tpu_torch.io import dataset, png

torch.set_num_threads(1)

BPPS = (1, 2, 3, 4, 6, 8)
FILTERS = (0, 1, 2, 3, 4)


def _raw_rows(rng, height, width, bpp, kinds):
    """A decompressed IDAT stream: `height` rows of width * bpp random
    bytes, each prefixed by its filter type from `kinds`."""
    stride = width * bpp
    body = rng.integers(0, 256, (height, stride), dtype=np.uint8)
    kind = np.asarray([kinds[y % len(kinds)] for y in range(height)], np.uint8)[:, None]
    return np.hstack([kind, body]).tobytes(), stride


@pytest.mark.parametrize("bpp", BPPS)
@pytest.mark.parametrize("kind", FILTERS)
def test_unfilter_equals_plain_twin(kind, bpp):
    """One filter type on every row, odd widths, a one-row image, then the
    five types mixed row by row (each row's Up / Average / Paeth reading a
    row undone by another type)."""
    rng = np.random.default_rng(10 * kind + bpp)
    for height, width, kinds in ((1, 7, (kind,)), (5, 13, (kind,)), (9, 31, (kind,)),
                                 (11, 17, (kind,) + tuple(f for f in FILTERS if f != kind))):
        raw, stride = _raw_rows(rng, height, width, bpp, kinds)
        got = png.unfilter(raw, height, stride, bpp, "x.png")
        want = png.unfilter_plain(raw, height, stride, bpp, "x.png")
        assert got.dtype == np.uint8 and got.shape == (height, stride)
        np.testing.assert_array_equal(got, want)


def test_unfilter_rejects_what_the_twin_rejects():
    rng = np.random.default_rng(0)
    raw, stride = _raw_rows(rng, 4, 9, 3, (1, 2, 5, 0))
    for fn in (png.unfilter, png.unfilter_plain):
        with pytest.raises(ValueError, match=r"^bad\.png: row 2 has filter type 5$"):
            fn(raw, 4, stride, 3, "bad.png")
        with pytest.raises(ValueError, match=r"^short\.png: image data too short$"):
            fn(raw[:-1], 4, stride, 3, "short.png")


def _pil_files(tmp_path):
    """(name, path) of PNGs written by PIL: L, RGB, RGBA, LA, palette,
    16-bit gray, and an RGB image of gradients and noise, which PIL saves
    with its own per-row adaptive filters."""
    rng = np.random.default_rng(5)
    h, w = 37, 53
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([(3 * x + y) % 256, (4 * y) % 256, (x * y // 7) % 256], -1)
    smooth = (smooth + rng.integers(0, 6, smooth.shape)).astype(np.uint8)
    images = {
        "L": Image.fromarray(rgb[..., 0]),
        "RGB": Image.fromarray(rgb),
        "RGBA": Image.fromarray(np.dstack([rgb, rgb[..., :1]]), "RGBA"),
        "LA": Image.fromarray(rgb[..., :2].copy(), "LA"),
        "P": Image.fromarray(rgb).quantize(16),
        "I;16": Image.fromarray(rng.integers(0, 1200, (h, w)).astype(np.uint16)),
        "RGB adaptive": Image.fromarray(smooth),
    }
    out = []
    for name, im in images.items():
        path = str(tmp_path / f"{name.replace(' ', '_').replace(';', '')}.png")
        im.save(path)
        out.append((name, path))
    return out


def _filter_types(path):
    arr, mode, _ = png.read_png(path)
    with open(path, "rb") as f:
        data = f.read()
    import zlib

    idat = b"".join(body for kind, body in png._chunks(data, path) if kind == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(arr.shape[0], -1)[:, 0].tolist())


def test_files_decode_as_pil_with_either_unfilter(tmp_path, monkeypatch):
    files = _pil_files(tmp_path)
    assert len(_filter_types(dict(files)["RGB adaptive"])) >= 2
    for name, path in files:
        pil = Image.open(path)
        arr, mode, palette = png.read_png(path)
        assert mode == pil.mode, name
        np.testing.assert_array_equal(arr, np.asarray(pil), err_msg=name)
        np.testing.assert_array_equal(png.to_rgb(arr, mode, palette),
                                      np.asarray(pil.convert("RGB")), err_msg=name)
    compiled = [png.read_png(p)[0] for _, p in files]
    monkeypatch.setattr(png, "unfilter", png.unfilter_plain)
    for (name, path), got in zip(files, compiled):
        np.testing.assert_array_equal(got, png.read_png(path)[0], err_msg=name)


def test_smoke_encoder_files_decode_exactly(tmp_path):
    """chip_smoke.py's adaptive-filter encoder: its gray and RGB files use
    several filter types per image and decode to the image, through the
    port and through PIL."""
    import chip_smoke

    rng = np.random.default_rng(6)
    y, x = np.mgrid[0:48, 0:65]
    gray = ((2 * x + 3 * y) % 256 + rng.integers(0, 9, x.shape)).astype(np.uint8)
    rgb = np.dstack([gray, gray[::-1], 255 - gray])
    for name, img in (("gray", gray), ("rgb", rgb)):
        path = str(tmp_path / f"{name}.png")
        used = chip_smoke.filtered_png(path, img)
        assert (used > 0).sum() >= 3, used
        assert len(_filter_types(path)) >= 3
        np.testing.assert_array_equal(png.read_png(path)[0], img)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


# ---------------------------------------------------------------- the loader
def _frames(tmp_path, n=8, size=(16, 16), seed=4):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, size, np.uint8) for _ in range(n)]
    paths = []
    for i, im in enumerate(imgs):
        p = tmp_path / f"{i}.png"
        Image.fromarray(im).save(p)
        paths.append(str(p))
    return imgs, paths


def test_frame_loader_sequential_and_skip(tmp_path):
    """JAX's scenario: frames 0-3 in order, then a skip past the prefetch
    window (ahead=2) to frame 7; each frame equals load_gray and JAX's
    loader."""
    imgs, paths = _frames(tmp_path)
    with native.FrameLoader(paths, 16, 16, ahead=2) as loader:
        for i in range(4):
            got = loader.get(i)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, imgs[i].astype(np.float32))
            np.testing.assert_array_equal(got, dataset.load_gray(paths[i]))
        np.testing.assert_array_equal(loader.get(7), imgs[7].astype(np.float32))
        with pytest.raises(RuntimeError, match="increasing order"):
            loader.get(5)
        assert len(loader.wait_s) == 5
    assert not loader._thread.is_alive()
    jl = jnative.FrameLoader(paths, 16, 16, ahead=2)
    try:
        np.testing.assert_array_equal(jl.get(0), imgs[0].astype(np.float32))
    finally:
        jl.close()


def test_frame_loader_reads_ahead_and_closes_mid_stream(tmp_path):
    imgs, paths = _frames(tmp_path)
    loader = native.FrameLoader(paths, 16, 16, ahead=3)
    np.testing.assert_array_equal(loader.get(0), imgs[0].astype(np.float32))
    deadline = time.monotonic() + 10.0
    while len(loader.decode_s) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    # the window: frame 0 taken, frames 1-4 decoded ahead, no more
    assert sorted(loader.decode_s) == [0, 1, 2, 3, 4]
    time.sleep(0.05)
    assert sorted(loader.decode_s) == [0, 1, 2, 3, 4]
    loader.close()
    assert not loader._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        loader.get(1)


def test_frame_loader_raises_for_a_bad_frame(tmp_path):
    """A corrupt file and a frame of the wrong size raise in their own
    get(i), with the path; the frames after them still load."""
    imgs, paths = _frames(tmp_path)
    with open(paths[2], "r+b") as f:
        f.seek(40)
        f.write(b"\xff" * 32)
    Image.fromarray(np.zeros((16, 17), np.uint8)).save(paths[4])
    with native.FrameLoader(paths, 16, 16) as loader:
        np.testing.assert_array_equal(loader.get(1), imgs[1].astype(np.float32))
        with pytest.raises(RuntimeError, match=f"frame 2 \\({paths[2]}\\)"):
            loader.get(2)
        np.testing.assert_array_equal(loader.get(3), imgs[3].astype(np.float32))
        with pytest.raises(RuntimeError, match=f"{paths[4]}.*17x16"):
            loader.get(4)
        np.testing.assert_array_equal(loader.get(5), imgs[5].astype(np.float32))


# --------------------------------------------------------------- map kernels
def _random_map(rng, K=7, N=40, max_pt=100, valid_frac=0.8):
    """tests/test_native.py's random map."""
    kf_matches = np.where(
        rng.random((K, N)) < 0.6, rng.integers(0, max_pt, (K, N)), -1
    ).astype(np.int32)
    kf_valid = (rng.random(K) < valid_frac).astype(np.uint8)
    kf_valid[0] = 1
    return kf_matches, kf_valid, max_pt


def _stats_inputs(rng, binary, K=7, N=40, max_pt=100, D=32):
    km, kv, _ = _random_map(rng, K, N, max_pt)
    if binary:
        kf_desc = rng.integers(0, 2, (K, N, D)).astype(np.uint8)
        pt_desc = np.zeros((max_pt, D), np.uint8)
    else:
        kf_desc = rng.normal(size=(K, N, D)).astype(np.float32)
        pt_desc = np.zeros((max_pt, D), np.float32)
    kf_size = rng.uniform(1, 3, (K, N)).astype(np.float32)
    kf_centers = rng.normal(size=(K, 3)).astype(np.float32)
    pt_ids = np.unique(rng.integers(0, max_pt, 60)).astype(np.int64)
    pt_pos = (rng.normal(size=(max_pt, 3)) * 3 + [0, 0, 5]).astype(np.float32)
    pt_ref_kf = rng.integers(-1, K, max_pt).astype(np.int32)
    outs = [pt_desc, np.zeros((max_pt, 3), np.float32)] + [
        np.full(max_pt, -1.0, np.float32) for _ in range(4)]
    return [km, kv, kf_desc, kf_size, kf_centers, pt_ids, pt_pos, pt_ref_kf] + outs


def _run_stats(fn, args):
    args = [a.copy() for a in args]
    fn(*args)
    return args[8:]


@pytest.mark.parametrize("seed", range(3))
def test_graph_kernels_equal_twins(seed):
    rng = np.random.default_rng(seed)
    km, kv, mp = _random_map(rng)
    for t in range(km.shape[0]):
        np.testing.assert_array_equal(native.covisibility_weights(km, kv, t, mp),
                                      native.covisibility_weights_plain(km, kv, t, mp))
    np.testing.assert_array_equal(native.point_obs_counts(km, kv, mp),
                                  native.point_obs_counts_plain(km, kv, mp))
    np.testing.assert_array_equal(native.covisibility_matrix(km, kv, mp),
                                  native.covisibility_matrix_plain(km, kv, mp))


@pytest.mark.parametrize("binary", [True, False], ids=["bits", "float"])
def test_update_point_stats_equals_twin(binary):
    """Every output equal, floats bit for bit; rows of points not asked
    for are left as they were."""
    args = _stats_inputs(np.random.default_rng(7 + binary), binary)
    got = _run_stats(native.update_point_stats, args)
    want = _run_stats(native.update_point_stats_plain, args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    untouched = np.setdiff1d(np.arange(args[6].shape[0]), args[5])
    assert (got[2][untouched] == -1.0).all()
    assert (got[2][args[5]] != -1.0).any()


@pytest.mark.skipif(not jnative.available(), reason="the JAX package's native library "
                    "does not build here")
@pytest.mark.parametrize("seed", range(3))
def test_map_kernels_equal_jax_native(seed):
    rng = np.random.default_rng(seed)
    km, kv, mp = _random_map(rng)
    for t in range(km.shape[0]):
        np.testing.assert_array_equal(native.covisibility_weights(km, kv, t, mp),
                                      jnative.covisibility_weights(km, kv, t, mp))
    np.testing.assert_array_equal(native.point_obs_counts(km, kv, mp),
                                  jnative.point_obs_counts(km, kv, mp))
    np.testing.assert_array_equal(native.covisibility_matrix(km, kv, mp),
                                  jnative.covisibility_matrix(km, kv, mp))
    for binary in (True, False):
        args = _stats_inputs(np.random.default_rng(100 + seed), binary)
        got = _run_stats(native.update_point_stats, args)
        want = _run_stats(jnative.update_point_stats, args)
        np.testing.assert_array_equal(got[0], want[0])     # the chosen descriptor rows
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=5e-7, atol=5e-7)


def test_slam_map_runs_the_compiled_kernels(monkeypatch):
    """SlamMap's counts, weights and statistics come from the library:
    with its functions made to raise, the map's methods raise."""
    from anyfeature_vslam_tpu_torch.slam.map_state import SlamMap

    m = SlamMap(max_kf=4, max_pt=16, n_feat=8, desc_dim=8, device="cpu")
    m.kf_valid[:2] = True
    m.kf_matches[0, :3] = [1, 2, 3]
    m.kf_matches[1, :2] = [2, 3]
    m.pt_valid[1:4] = True
    assert m.covisibility_weights(0)[1] == 2
    assert list(m.point_observation_counts()[1:4]) == [1, 2, 2]
    m.update_point_stats([2])

    def boom(*a, **k):
        raise AssertionError("compiled kernel called")

    for name in ("covisibility_weights", "point_obs_counts", "update_point_stats"):
        monkeypatch.setattr(native, name, boom)
    m.rev += 1
    for call in (lambda: m.covisibility_weights(0), m.point_observation_counts,
                 lambda: m.update_point_stats([2])):
        with pytest.raises(AssertionError, match="compiled kernel called"):
            call()


# ------------------------------------------------------------------- build
def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="no-such-c\\+\\+"):
        native.lib()
    assert not native.available()
    with pytest.raises(RuntimeError, match="no-such-c\\+\\+"):
        png.unfilter(b"\x00\x01", 1, 1, 1)
    assert not (tmp_path / "_build").exists() or not list((tmp_path / "_build").glob("*.so"))


def test_builds_into_an_empty_folder(tmp_path, monkeypatch):
    """The library builds from csrc/ at first use, without a build left by
    an earlier run."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    native.lib()
    built = list((tmp_path / "_build").glob("libslam_native-*.so"))
    assert len(built) == 1 and os.path.getsize(built[0]) > 0
    raw, stride = _raw_rows(np.random.default_rng(1), 3, 5, 2, (4, 3, 1))
    np.testing.assert_array_equal(png.unfilter(raw, 3, stride, 2),
                                  png.unfilter_plain(raw, 3, stride, 2))
