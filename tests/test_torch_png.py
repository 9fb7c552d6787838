"""The port's PNG reader and writer (anyfeature_vslam_tpu_torch/io/png.py)
and the frame loaders on it (io/dataset.py load_gray / load_depth) against
PIL and the JAX package's loaders, and the port's CLI with PIL blocked.

Tolerances: none. Decoded arrays equal ``np.asarray(PIL.Image.open(...))``
in dtype and value, and ``load_gray`` / ``load_depth`` equal the JAX
package's float32 arrays exactly (``np.array_equal``): the same float32
expression on the same RGB bytes.
"""

import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from anyfeature_vslam_tpu.io import dataset as jdataset
from anyfeature_vslam_tpu_torch.io import dataset as tdataset
from anyfeature_vslam_tpu_torch.io import png, viewer

W, H = 37, 23  # odd sizes: rows whose bytes do not divide evenly


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _image(channels, dtype=np.uint8, seed=0):
    """A smooth gradient plus noise, so every filter sees carries and
    sign changes."""
    rng = np.random.default_rng(seed)
    top = 65535 if dtype == np.uint16 else 255
    y, x = np.mgrid[0:H, 0:W]
    base = (x * 7 + y * 5)[..., None] * (1 + np.arange(channels))
    noise = rng.integers(0, top // 4, (H, W, channels))
    a = ((base * (top // 300) + noise) % (top + 1)).astype(dtype)
    return a[..., 0] if channels == 1 else a


def _filter_row(kind, row, prior, bpp):
    """One scanline filtered with `kind` (PNG spec, section 9)."""
    row, prior = row.astype(np.int64), prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) // 2
    else:
        p = left + prior - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
    return ((row - pred) % 256).astype(np.uint8)


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _write_filtered(path, img, ctype, depth, kinds, interlace=0):
    """A PNG of `img` whose rows use the filter types `kinds` in turn."""
    if depth == 16:
        raw = img.astype(">u2").reshape(H, -1).view(np.uint8)
    else:
        raw = np.ascontiguousarray(img, np.uint8).reshape(H, -1)
    channels = raw.shape[1] // W // (depth // 8)
    bpp = channels * depth // 8
    prior = np.zeros(raw.shape[1], np.uint8)
    out = []
    for y in range(H):
        kind = kinds[y % len(kinds)]
        out.append(np.concatenate([[np.uint8(kind)], _filter_row(kind, raw[y], prior, bpp)]))
        prior = raw[y]
    data = np.concatenate(out).tobytes()
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0,
                                                            interlace))
                + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


# colour type, bit depth, channels, PIL mode
FORMATS = {"gray8": (0, 8, 1, "L"), "gray16": (0, 16, 1, "I;16"), "rgb8": (2, 8, 3, "RGB"),
           "la8": (4, 8, 2, "LA"), "rgba8": (6, 8, 4, "RGBA")}


def _check_loaders(path):
    arr, mode, _ = png.read_png(path)
    with Image.open(path) as im:
        want = np.asarray(im)
        assert mode == im.mode
    assert arr.dtype == want.dtype and np.array_equal(arr, want)
    for port, jax in ((tdataset.load_gray, jdataset.load_gray),
                      (tdataset.load_depth, jdataset.load_depth)):
        got, ref = port(path), jax(path)
        assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref), port.__name__
    got, ref = tdataset.load_depth(path, 1.0 / 5000), jdataset.load_depth(path, 1.0 / 5000)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_each_filter_type_decodes_as_pil_does(tmp_path, fmt, kind):
    """Every row filtered with one type (and, for kind 0, all five types
    in turn): the decoded array equals PIL's, the loaders equal JAX's."""
    ctype, depth, channels, _ = FORMATS[fmt]
    img = _image(channels, np.uint16 if depth == 16 else np.uint8, seed=kind)
    path = str(tmp_path / f"{fmt}_{kind}.png")
    _write_filtered(path, img, ctype, depth, [kind])
    _check_loaders(path)
    if kind == 0:
        _write_filtered(path, img, ctype, depth, [0, 1, 2, 3, 4])
        _check_loaders(path)


def _pil_image(mode, seed=0):
    if mode == "I;16":
        return Image.fromarray(_image(1, np.uint16, seed))
    if mode.startswith("P"):
        n = int(mode[1:])
        im = Image.fromarray((_image(1, np.uint16, seed) % n).astype(np.uint8), "P")
        im.putpalette(np.random.default_rng(seed).integers(0, 256, 3 * n).tolist())
        return im
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    return Image.fromarray(_image(channels, seed=seed), mode)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P256", "P16", "P4", "P2", "I;16"])
def test_pil_written_pngs(tmp_path, mode):
    """PNGs as PIL writes them (its adaptive row filters; a small palette
    at 1, 2 or 4 bits per index): decoded as PIL decodes them, the loaders
    equal to JAX's."""
    path = str(tmp_path / "img.png")
    _pil_image(mode).save(path)
    _check_loaders(path)


def test_interlaced_png_raises(tmp_path):
    path = str(tmp_path / "interlaced.png")
    _write_filtered(path, _image(1), 0, 8, [0], interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(path)
    with pytest.raises(ValueError, match="interlaced"):
        tdataset.load_gray(path)


@pytest.mark.parametrize("img", [_image(1), _image(3)], ids=["gray", "rgb"])
def test_write_png_reads_back(tmp_path, img):
    """write_png's gray and RGB files: PIL and read_png give the array
    back; the viewer writes its overlays with this function."""
    path = str(tmp_path / "out.png")
    png.write_png(path, img, {"slam_state": "OK"})
    with Image.open(path) as im:
        assert np.array_equal(np.asarray(im), img) and im.info["slam_state"] == "OK"
    arr, mode, _ = png.read_png(path)
    assert mode == ("L" if img.ndim == 2 else "RGB") and np.array_equal(arr, img)
    assert viewer.write_png is png.write_png


def test_other_formats_need_pil(tmp_path, monkeypatch):
    """A BMP frame: through PIL equal to JAX's; with PIL blocked a
    ValueError naming the file and its format. A PNG never reaches PIL."""
    path = str(tmp_path / "frame.bmp")
    Image.fromarray(_image(3), "RGB").save(path)
    assert np.array_equal(tdataset.load_gray(path), jdataset.load_gray(path))
    png_path = str(tmp_path / "frame.png")
    Image.fromarray(_image(3), "RGB").save(png_path)
    want = jdataset.load_gray(png_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ValueError, match=r"frame\.bmp.*BMP"):
        tdataset.load_gray(path)
    assert np.array_equal(tdataset.load_gray(png_path), want)


def test_run_mono_without_pil(tmp_path, monkeypatch):
    """The port's sequence tool and CLI with PIL blocked: the first 6
    frames of the bench sequence at 320x240 written by make_synth_sequence,
    read back by run_mono on the CPU, which tracks and writes its
    trajectory files."""
    from anyfeature_vslam_tpu_torch import run_mono
    from anyfeature_vslam_tpu_torch.tools import make_synth_sequence

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    seq, out = str(tmp_path / "seq"), str(tmp_path / "out")
    assert make_synth_sequence.main([f"out_dir:{seq}", "n_frames:150", "max_frames:6",
                                     "width:320", "height:240", "revisit:0.2", "seed:3"]) == 0
    assert run_mono.main([f"sequence_path:{seq}", f"exp_folder:{out}", "exp_id:t",
                          "n_features:600", "verbose:0", "device:cpu"]) == 0
    for name in ("t_KeyFrameTrajectory.csv", "t_FrameTrajectory_TUM.txt",
                 "t_FrameTrajectory_KITTI.txt", "t_statistics.yaml"):
        assert os.path.getsize(os.path.join(out, name)) > 0, name
    with open(os.path.join(out, "t_FrameTrajectory_TUM.txt")) as f:
        rows = [r for r in f.read().splitlines() if r and not r.startswith("#")]
    assert len(rows) >= 4
