"""PNG files with zlib and struct only, so frames, depth maps and the
viewer's overlays need no PIL.

``read_png`` decodes non-interlaced PNGs to the array that
``np.asarray(PIL.Image.open(path))`` gives, with PIL's mode beside it:

- colour type 0 (gray): bit depth 8 -> "L" uint8; 16 -> "I;16" uint16;
- 2 (RGB, depth 8) -> "RGB" (H, W, 3); 3 (palette, depth 1, 2, 4 or 8, as
  PIL writes small palettes) -> "P", the indices, with the palette as an
  (n, 3) uint8 array; 4 (gray + alpha, depth 8) -> "LA" (H, W, 2); 6
  (RGBA, depth 8) -> "RGBA" (H, W, 4).

Ancillary chunks (tRNS, gAMA, tEXt, ...) are skipped; interlaced files and
other bit depths raise ``ValueError``. ``to_rgb`` is PIL's
``convert("RGB")`` of such an array: alpha dropped, palette looked up,
16-bit gray clipped to 255.

``write_png`` writes an (H, W) uint8 array as 8-bit gray or an (H, W, 3)
one as 8-bit RGB, every row with filter type 0 (None).

The row filters are undone by the host library (``native.unfilter``,
csrc/slam_native.cpp); ``unfilter_plain`` is its numpy / Python twin, which
the tests hold it against.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# (colour type, bit depth) -> (channels, PIL mode)
_FORMATS = {
    (0, 8): (1, "L"), (0, 16): (1, "I;16"),
    (2, 8): (3, "RGB"),
    (3, 1): (1, "P"), (3, 2): (1, "P"), (3, 4): (1, "P"), (3, 8): (1, "P"),
    (4, 8): (2, "LA"),
    (6, 8): (4, "RGBA"),
}


def _chunks(data: bytes, path: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _paeth_row(line: list, prior: list, bpp: int) -> list:
    out = line
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        out[i] = (out[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
    return out


def _average_row(line: list, prior: list, bpp: int) -> list:
    out = line
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def unfilter(raw: bytes, height: int, stride: int, bpp: int, path: str = "") -> np.ndarray:
    """The (height, stride) uint8 scanlines of a decompressed IDAT stream,
    each row's filter (None, Sub, Up, Average, Paeth) undone by the host
    library; ValueError with `path` for data that is too short or an
    unknown filter type."""
    return native.unfilter(raw, height, stride, bpp, path)


def unfilter_plain(raw: bytes, height: int, stride: int, bpp: int, path: str = "") -> np.ndarray:
    """unfilter's plain twin. None, Sub and Up are numpy operations on the
    row; Average and Paeth depend on the reconstructed byte to the left and
    run as a Python loop over the row."""
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < height * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    rows = buf[:height * (stride + 1)].reshape(height, stride + 1)
    kinds = rows[:, 0]
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        line = rows[y, 1:]
        kind = kinds[y]
        if kind == 0:
            cur = line
        elif kind == 1:
            # Sub: a cumulative sum, mod 256, of every bpp-th byte
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind == 3:
            cur = np.array(_average_row(line.tolist(), prior.tolist(), bpp), np.uint8)
        elif kind == 4:
            cur = np.array(_paeth_row(line.tolist(), prior.tolist(), bpp), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {int(kind)}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str):
    """(array, mode, palette) of the PNG file at `path`; see the module
    docstring."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown compression {comp} or filter method {filt}")
    if (ctype, depth) not in _FORMATS:
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth} is not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    channels, mode = _FORMATS[(ctype, depth)]
    bits = channels * depth
    stride = (w * bits + 7) // 8
    rows = unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, bits // 8), path)
    if depth == 16:
        arr = rows.view(">u2").reshape(h, w).astype(np.uint16)
    elif depth == 8:
        arr = rows.reshape(h, w, channels) if channels > 1 else rows
    else:
        # palette indices packed MSB first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
        arr = vals.reshape(h, -1)[:, :w]
    return np.ascontiguousarray(arr), mode, palette


def to_rgb(arr: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a decoded array: (H, W, 3) uint8."""
    if mode == "RGB":
        return arr
    if mode == "RGBA":
        return arr[..., :3]
    if mode == "P":
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[arr]
    if mode == "I;16":
        gray = np.minimum(arr, 255).astype(np.uint8)
    elif mode == "LA":
        gray = arr[..., 0]
    else:
        gray = arr
    return np.repeat(gray[..., None], 3, axis=-1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, text: dict | None = None):
    """An (H, W) uint8 array as an 8-bit gray PNG, or an (H, W, 3) one as
    8-bit RGB; `text`: Latin-1 key -> value pairs, one ``tEXt`` chunk each."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype, channels = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, channels = 2, 3
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) arrays, not {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),  # filter type 0 per row
                           img.reshape(h, channels * w)], axis=1)
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    for key, value in (text or {}).items():
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1")))
    out += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)), _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(out))
