"""A frame's features worked out again, in plain PyTorch.

Each function follows the extractor's definition: orb32 is an 8-level
pyramid (anti-aliased bilinear resize, levels cascaded), FAST-9 scores with
3x3 non-maximum suppression over the threshold, each level's budget of
keypoints selected spread over a grid of cells, the intensity-centroid
angle on the radius-15 patch of the sigma-2 blurred level, and 256 steered
BRIEF tests on bf16-rounded samples (30 rotation steps, pairs drawn from a
fixed-seed Gaussian); sift128 is a Gaussian scale space (2 slices per
octave, sigma0 1.6), the 36-bin dominant gradient orientation and 4x4x8
gradient histograms sampled on a rotated 20x20 grid (16 rotation steps).

``precision`` is the dtype each stage's image is rounded to: float32 for
the reference itself, bfloat16 for the control that a run must tell apart
from the program. Matrix products run in float32 with TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------- shared


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 anti-aliased bilinear resize along one axis:
    half-pixel centres, a triangle kernel stretched by the downscale, rows
    renormalised at the edges."""
    scale = n_out / n_in
    inv = 1.0 / scale
    radius = max(1.0, inv)
    out = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        x = (i + 0.5) * inv - 0.5
        js = np.arange(max(int(np.floor(x - radius)), 0), min(int(np.ceil(x + radius)) + 1, n_in))
        w = np.maximum(0.0, 1.0 - np.abs((js - x) * min(scale, 1.0)))
        if w.sum() > 0:
            out[i, js] = w / w.sum()
    return out


def gaussian_taps(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def blur(img, taps):
    """Separable blur with edge replication, rows then columns, summed tap
    by tap."""
    r = (len(taps) - 1) // 2
    h, w = img.shape
    p = torch.cat([img[:1].expand(r, w), img, img[-1:].expand(r, w)], 0)
    out = taps[0] * p[0:h]
    for i in range(1, len(taps)):
        out = out + taps[i] * p[i:i + h]
    p = torch.cat([out[:, :1].expand(h, r), out, out[:, -1:].expand(h, r)], 1)
    res = taps[0] * p[:, 0:w]
    for i in range(1, len(taps)):
        res = res + taps[i] * p[:, i:i + w]
    return res


def patches(img, xy, radius: int):
    """(N, 2r+1, 2r+1) patches at the rounded points, edges replicated."""
    h, w = img.shape
    xi = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, h - 1)
    offs = torch.arange(2 * radius + 1, device=img.device)
    rows = torch.clamp(yi[:, None] + offs[None, :] - radius, 0, h - 1)
    cols = torch.clamp(xi[:, None] + offs[None, :] - radius, 0, w - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def rounder(precision):
    """The rounding applied to each stage's image."""
    if precision == torch.float32:
        return lambda t: t
    return lambda t: t.to(precision).to(torch.float32)


# ---------------------------------------------------------------- orb32

RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
SELECT_BORDER = 16  # pixels of a level where no keypoint is selected
SELECT_PER_CELL = 4  # candidates a selection cell keeps before the ranking
BRIEF_BITS = 256
BRIEF_ROT = 30
BRIEF_SEED = 20240607
PATCH_R = 15


def orb_level_shapes(h: int, w: int, n_levels: int, scale: float):
    return [(max(int(round(h * (1.0 / scale ** l))), 16), max(int(round(w * (1.0 / scale ** l))), 16))
            for l in range(n_levels)]


def orb_levels(img, n_levels: int, scale: float, precision=torch.float32):
    """The pyramid, each level resized from the one before it."""
    q = rounder(precision)
    shapes = orb_level_shapes(img.shape[0], img.shape[1], n_levels, scale)
    levels = [q(img)]
    for l in range(1, n_levels):
        (h1, w1), (h2, w2) = shapes[l - 1], shapes[l]
        wr = torch.from_numpy(resize_weights(h1, h2)).to(img.device)
        wc = torch.from_numpy(resize_weights(w1, w2)).to(img.device)
        levels.append(q((wr @ levels[-1]) @ wc.T))
    return levels


def fast_nms(img, threshold: float):
    """FAST-9 score (the best 9-arc's least difference, bright or dark,
    counted only over the threshold), 3-pixel border zeroed, then kept only
    where it is the 3x3 maximum (ties kept)."""
    h, w = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    d = torch.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img for dy, dx in RING])
    ext = torch.cat([d, d[:8]], 0)
    lo = ext[0:16]
    hi = ext[0:16]
    for k in range(1, 9):
        lo = torch.minimum(lo, ext[k:k + 16])
        hi = torch.maximum(hi, ext[k:k + 16])
    bright = lo.amax(0)
    dark = -hi.amin(0)
    zero = torch.zeros_like(bright)
    score = torch.maximum(torch.where(bright > threshold, bright, zero),
                          torch.where(dark > threshold, dark, zero))
    inner = torch.zeros_like(score, dtype=torch.bool)
    inner[3:h - 3, 3:w - 3] = True
    score = torch.where(inner, score, zero)
    top = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= top) & (score > 0), score, zero)


def brief_tables():
    """(p1, p2): (BRIEF_ROT, BRIEF_BITS) flat indices into the 31x31 patch
    of each test's two points at each rotation step; a test whose points
    round to one pixel reads pixel 0 twice (and gives 0)."""
    rng = np.random.default_rng(BRIEF_SEED + BRIEF_BITS)
    pts = rng.normal(0.0, 31.0 / 5.0, size=(BRIEF_BITS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = (pts * np.minimum(1.0, 13.0 / np.maximum(norm, 1e-9))).astype(np.float32)
    side = 2 * PATCH_R + 1
    p1 = np.zeros((BRIEF_ROT, BRIEF_BITS), np.int64)
    p2 = np.zeros((BRIEF_ROT, BRIEF_BITS), np.int64)
    for r in range(BRIEF_ROT):
        th = 2.0 * np.pi * r / BRIEF_ROT
        ca, sa = np.cos(th), np.sin(th)
        rx = np.round(pts[..., 0] * ca - pts[..., 1] * sa).astype(np.int64)
        ry = np.round(pts[..., 0] * sa + pts[..., 1] * ca).astype(np.int64)
        flat = (ry + PATCH_R) * side + (rx + PATCH_R)
        same = flat[:, 0] == flat[:, 1]
        p1[r] = np.where(same, 0, flat[:, 0])
        p2[r] = np.where(same, 0, flat[:, 1])
    return p1, p2


def orb_describe(level, xy, precision=torch.float32):
    """(angle (N,), bits (N, 256) uint8) of level-pixel keypoints xy."""
    q = rounder(precision)
    dev = level.device
    blurred = q(blur(level, torch.from_numpy(gaussian_taps(2.0, 3)).to(dev)))
    flat = patches(blurred, xy, PATCH_R).reshape(xy.shape[0], -1)
    ys, xs = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
    mask = (ys * ys + xs * xs) <= PATCH_R * PATCH_R
    mom = torch.from_numpy(np.stack([(xs * mask).reshape(-1), (ys * mask).reshape(-1)], 1)
                           .astype(np.float32)).to(dev)
    m = flat @ mom
    angle = torch.atan2(m[:, 1], m[:, 0])
    step = torch.round(angle * (BRIEF_ROT / (2.0 * math.pi))).to(torch.int64) % BRIEF_ROT
    p1, p2 = (torch.from_numpy(t).to(dev) for t in brief_tables())
    b = flat.to(torch.bfloat16).to(torch.float32)
    bits = (torch.gather(b, 1, p2[step]) - torch.gather(b, 1, p1[step])) > 0
    return angle, bits.to(torch.uint8)


def _orb_groups(img_u8, uv, octave, cfg, precision):
    """Per pyramid level with keypoints: (level image, indices of its
    keypoints, their level pixels)."""
    levels = orb_levels(img_u8.to(torch.float32), cfg["n_levels"], cfg["scale_factor"], precision)
    for level, sel, xy, _ in _orb_groups_at(levels, uv, octave, cfg):
        yield level, sel, xy


def _orb_groups_at(levels, uv, octave, cfg):
    for l, level in enumerate(levels):
        sel = torch.nonzero(octave == l)[:, 0]
        if sel.numel():
            s = float(np.float32(cfg["scale_factor"] ** l))
            yield level, sel, torch.round(uv[sel].to(torch.float64) / s).to(torch.float32), l


def orb_descriptors(img_u8, uv, octave, cfg: dict, precision=torch.float32):
    """(N, 256) uint8 descriptors of the keypoints (level-0 pixels uv, their
    octaves), worked out at `precision`."""
    out = torch.zeros((uv.shape[0], BRIEF_BITS), dtype=torch.uint8, device=uv.device)
    for level, sel, xy in _orb_groups(img_u8, uv, octave, cfg, precision):
        out[sel] = orb_describe(level, xy, precision)[1]
    return out


def level_budgets(n_features: int, n_levels: int, scale: float) -> list:
    """Keypoints per level, a geometric share of the total (ORB-SLAM2's
    ORBextractor), each rounded, the last level taking what is left."""
    factor = 1.0 / scale
    desired = n_features * (1 - factor) / (1 - factor ** n_levels)
    out = []
    for _ in range(n_levels - 1):
        out.append(int(round(desired)))
        desired *= factor
    return out + [max(n_features - sum(out), 0)]


def spread_select(score: np.ndarray, budget: int) -> set:
    """The level pixels (x, y) that the extractor selects from a score map:
    the level, less its border, cut into a grid of about `budget` cells
    of its aspect; each cell's best ``SELECT_PER_CELL`` scores (the lower
    pixel first on ties, row-major in the cell); then every cell's first
    before any cell's second, and so on, by score within a rank (the
    float32 key -rank * 1e6 + score, positive scores only), the lower cell
    first on equal keys; the first `budget` of them."""
    h, w = score.shape
    s = np.zeros_like(score, dtype=np.float32)
    b = SELECT_BORDER
    s[b:h - b, b:w - b] = score[b:h - b, b:w - b]
    gy = max(int(round(math.sqrt(budget * h / max(w, 1)))), 1)
    gx = max((budget + gy - 1) // gy, 1)
    ch, cw = -(-h // gy), -(-w // gx)
    pad = np.zeros((gy * ch, gx * cw), np.float32)
    pad[:h, :w] = s
    cells = pad.reshape(gy, ch, gx, cw).transpose(0, 2, 1, 3).reshape(gy * gx, ch * cw)
    k = min(SELECT_PER_CELL, ch * cw)
    pick = np.argsort(-cells, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(cells, pick, 1)
    rank = np.broadcast_to(np.arange(k), top.shape)
    key = np.where(top > 0, (-rank * 1e6).astype(np.float32) + np.minimum(top, np.float32(1e5)),
                   np.float32(-np.inf))
    flat = np.argsort(-key.reshape(-1), kind="stable")[:budget]
    out = set()
    for f in flat:
        c, r = divmod(int(f), k)
        if top[c, r] > 0:
            y = (c // gx) * ch + int(pick[c, r]) // cw
            x = (c % gx) * cw + int(pick[c, r]) % cw
            out.add((x, y))
    return out


def orb_check(img_u8, uv, octave, desc, cfg: dict):
    """Per keypoint (N,) bool, True where the reference disagrees with the
    keypoints and descriptors under test: the keypoint is no FAST-9
    maximum over the threshold at its level, or the descriptor differs
    from the reference's in more than ``max_bits`` bits. Also the
    keypoints that the reference selects at each level (``spread_select``
    over its FAST-9 score map, the level's budget of ``n_features``) and
    the ones under test lack. Returns (bad, bits that differ, missing)."""
    bad = torch.zeros(uv.shape[0], dtype=torch.bool, device=uv.device)
    ham = torch.zeros(uv.shape[0], dtype=torch.int64, device=uv.device)
    budgets = level_budgets(int(cfg["n_features"]), cfg["n_levels"], cfg["scale_factor"])
    missing = 0
    levels = orb_levels(img_u8.to(torch.float32), cfg["n_levels"], cfg["scale_factor"])
    groups = {l: (sel, xy) for _, sel, xy, l in _orb_groups_at(levels, uv, octave, cfg)}
    for l, level in enumerate(levels):
        score = fast_nms(level, cfg["detect_th"])
        chosen = spread_select(score.cpu().numpy(), budgets[l])
        if l not in groups:
            missing += len(chosen)
            continue
        sel, xy = groups[l]
        xi = torch.clamp(xy[:, 0].to(torch.int64), 0, level.shape[1] - 1)
        yi = torch.clamp(xy[:, 1].to(torch.int64), 0, level.shape[0] - 1)
        ham[sel] = (orb_describe(level, xy)[1] != desc[sel]).sum(1)
        bad[sel] = (score[yi, xi] <= 0) | (ham[sel] > cfg["max_bits"])
        missing += len(chosen - set(zip(xi.tolist(), yi.tolist())))
    return bad, ham, missing


# -------------------------------------------------------------- sift128

SIGMA0 = 1.6
ASSUMED_BLUR = 0.5
MIN_OCTAVE_DIM = 32
GRID = 20
CELLS = 4
DESC_ROT = 16
ORI_BINS = 36


def sift_octaves(img, n_levels: int, precision=torch.float32):
    """Per octave its nspo + 3 Gaussian slices (nspo = n_levels / 4), the
    first blurred from the image's assumed 0.5 to sigma0, each next one by
    the increment, each next octave's first slice the slice at 2 sigma0
    halved by the resize matrices."""
    q = rounder(precision)
    dev = img.device
    nspo = max(n_levels // 4, 1)
    h, w = img.shape
    n_oct = 1
    while n_oct < max(n_levels // nspo, 1) and min(h, w) // (2 ** n_oct) >= MIN_OCTAVE_DIM:
        n_oct += 1
    k = 2.0 ** (1.0 / nspo)
    sig = [SIGMA0 * (k ** i) for i in range(nspo + 3)]

    def taps(s):
        return torch.from_numpy(gaussian_taps(s, max(int(np.ceil(3.0 * s)), 1))).to(dev)

    inc = [taps(float(np.sqrt(sig[i] ** 2 - sig[i - 1] ** 2))) for i in range(1, nspo + 3)]
    base = q(blur(img, taps(float(np.sqrt(SIGMA0 ** 2 - ASSUMED_BLUR ** 2)))))
    octaves = []
    for o in range(n_oct):
        if o > 0:
            prev = octaves[-1][nspo]
            h1, w1 = prev.shape
            h2, w2 = max(h1 // 2, MIN_OCTAVE_DIM // 2), max(w1 // 2, MIN_OCTAVE_DIM // 2)
            wr = torch.from_numpy(resize_weights(h1, h2)).to(dev)
            wc = torch.from_numpy(resize_weights(w1, w2)).to(dev)
            base = q(wr @ (prev @ wc.T))
        slices = [base]
        for t in inc:
            slices.append(q(blur(slices[-1], t)))
        octaves.append(slices)
    return octaves, sig, nspo


def _grid_matrix():
    """(961, DESC_ROT * 400) float32 bilinear weights of the rotated 20x20
    sample grid (1-pixel spacing) in the 31x31 patch, rounded to bf16."""
    side = 2 * PATCH_R + 1
    half = (GRID - 1) / 2.0
    ys, xs = np.mgrid[0:GRID, 0:GRID].astype(np.float32)
    gx, gy = (xs - half).reshape(-1), (ys - half).reshape(-1)
    m = np.zeros((side * side, DESC_ROT * GRID * GRID), np.float32)
    for r in range(DESC_ROT):
        th = 2.0 * np.pi * r / DESC_ROT
        x = np.clip(gx * np.cos(th) - gy * np.sin(th) + PATCH_R, 0.0, side - 1.001)
        y = np.clip(gx * np.sin(th) + gy * np.cos(th) + PATCH_R, 0.0, side - 1.001)
        x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
        fx, fy = x - x0, y - y0
        cols = r * GRID * GRID + np.arange(GRID * GRID)
        for dy, dx, wgt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                            (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
            np.add.at(m, ((y0 + dy) * side + (x0 + dx), cols), wgt)
    return torch.from_numpy(m).to(torch.bfloat16).to(torch.float32)


def _cell_matrix():
    cell = np.clip(np.mgrid[0:GRID, 0:GRID][0] * CELLS // GRID, 0, CELLS - 1)
    cid = cell.reshape(-1) * CELLS + cell.T.reshape(-1)
    m = np.zeros((GRID * GRID, CELLS * CELLS), np.float32)
    m[np.arange(GRID * GRID), cid] = 1.0
    return torch.from_numpy(m)


def _fma(a, b, c):
    """a * b + c rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _atan2(y, x):
    return torch.atan2(y.double(), x.double()).float()


def _binned_sum(values, bins, n: int):
    onehot = F.one_hot(bins, n).to(values.dtype)
    return (values[:, None, :] @ onehot)[:, 0]


def sift_describe(level, xy, mats):
    """(angle (N,), desc (N, 128)) of level-pixel keypoints xy."""
    grid_m, cell_m = mats
    n = xy.shape[0]
    gx = 0.5 * (torch.roll(level, -1, 1) - torch.roll(level, 1, 1))
    gy = 0.5 * (torch.roll(level, -1, 0) - torch.roll(level, 1, 0))
    gx[:, 0] = gx[:, -1] = 0.0
    gy[0, :] = gy[-1, :] = 0.0
    pgx = patches(gx, xy, PATCH_R).reshape(n, -1)
    pgy = patches(gy, xy, PATCH_R).reshape(n, -1)
    # dominant orientation: 36 bins over a Gaussian window of sigma 7.5,
    # smoothed twice by [1 4 6 4 1] / 16, first peak, parabolic fit
    ys, xs = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1].astype(np.float32)
    s = PATCH_R / 2.0
    win = torch.from_numpy(np.exp(-(xs * xs + ys * ys) / (2.0 * s * s)).reshape(-1)).to(xy.device)
    mag = torch.sqrt(pgx * pgx + pgy * pgy + 1e-12) * win
    binf = (_atan2(pgy, pgx) + math.pi) * (ORI_BINS / (2.0 * math.pi))
    hist = _binned_sum(mag, torch.clamp(binf.to(torch.int64) % ORI_BINS, 0, ORI_BINS - 1),
                       ORI_BINS)
    for _ in range(2):
        hist = (6.0 * hist + 4.0 * (torch.roll(hist, 1, 1) + torch.roll(hist, -1, 1))
                + (torch.roll(hist, 2, 1) + torch.roll(hist, -2, 1))) * (1.0 / 16.0)
    peak = torch.argmax(hist, dim=1, keepdim=True)
    hp = torch.gather(hist, 1, peak)[:, 0]
    hl = torch.gather(hist, 1, (peak - 1) % ORI_BINS)[:, 0]
    hr = torch.gather(hist, 1, (peak + 1) % ORI_BINS)[:, 0]
    den = hl - 2.0 * hp + hr
    frac = torch.where(torch.abs(den) > 1e-6, 0.5 * (hl - hr) / den, torch.zeros_like(den))
    angle = ((peak[:, 0].to(torch.float32) + torch.clamp(frac, -0.5, 0.5) + 0.5)
             * (2.0 * math.pi / ORI_BINS)) - math.pi
    # the grid sampled at the nearest of 16 steps, gradients turned into the
    # keypoint's frame, 8-bin histograms per 5x5-sample cell
    step = torch.round(angle * (DESC_ROT / (2.0 * math.pi))).to(torch.int64) % DESC_ROT
    bf = (lambda t: t.to(torch.bfloat16).to(torch.float32))
    sgx = (bf(pgx) @ grid_m).view(n, DESC_ROT, GRID * GRID)
    sgy = (bf(pgy) @ grid_m).view(n, DESC_ROT, GRID * GRID)
    pick = step[:, None, None].expand(n, 1, GRID * GRID)
    sgx = torch.gather(sgx, 1, pick)[:, 0]
    sgy = torch.gather(sgy, 1, pick)[:, 0]
    th = np.arange(DESC_ROT, dtype=np.float32) * np.float32(2.0 * math.pi / DESC_ROT)
    cs = torch.from_numpy(np.array([[math.cos(float(t)), math.sin(float(t))] for t in th],
                                   np.float32)).to(xy.device)[step]
    ca, sa = cs[:, 0:1], cs[:, 1:2]
    dx = _fma(ca, sgx, sa * sgy)
    dy = _fma(ca, sgy, -sa * sgx)
    m = torch.sqrt(dx * dx + dy * dy + 1e-12)
    b8 = torch.clamp(((_atan2(dy, dx) + math.pi) * (8 / (2 * math.pi))).to(torch.int64) % 8, 0, 7)
    comps = F.one_hot(b8, 8).to(m.dtype) * m[..., None]
    desc = (comps.transpose(1, 2) @ cell_m).transpose(1, 2).reshape(n, -1)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
    desc = torch.clamp(desc, max=0.25)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
    return angle, desc


def _sift_groups(img_u8, uv, octave, size, cfg, precision):
    """Per octave and slice: (slice image, indices of the keypoints whose
    size allows that slice, their level pixels, how far the size puts them
    from the slice). The map keeps a keypoint's octave and its size on
    ORB's band, not its slice; the subpixel scale offset keeps it within
    0.6 of its slice."""
    octaves, sig, nspo = sift_octaves(img_u8.to(torch.float32), cfg["n_levels"], precision)
    max_raw = (sig[nspo] / SIGMA0) * (2.0 ** (len(octaves) - 1)) * 2.0 ** 0.6
    raw = 1.0 + (size.to(torch.float64) - 1.0) * (max_raw - 1.0) / (1.2 ** 7 - 1.0)
    for o, slices in enumerate(octaves):
        sel = torch.nonzero(octave == o)[:, 0]
        if sel.numel() == 0:
            continue
        xy = (uv[sel].to(torch.float64) / 2.0 ** o).to(torch.float32)
        pos = nspo * (torch.log2(raw[sel]) - o)
        for i in range(1, nspo + 1):
            yield slices[i], sel, xy, torch.abs(pos - i)


def _sift_mats(device):
    return _grid_matrix().to(device), _cell_matrix().to(device)


def sift_descriptors(img_u8, uv, octave, size, cfg: dict, precision=torch.float32):
    """(N, 128) descriptors of the keypoints, each on the slice its size
    puts it nearest, worked out at `precision`."""
    mats = _sift_mats(uv.device)
    out = torch.zeros((uv.shape[0], 128), dtype=torch.float32, device=uv.device)
    gap = torch.full((uv.shape[0],), math.inf, dtype=torch.float64, device=uv.device)
    for level, sel, xy, dist in _sift_groups(img_u8, uv, octave, size, cfg, precision):
        d = sift_describe(level, xy, mats)[1]
        nearer = dist < gap[sel]
        out[sel] = torch.where(nearer[:, None], d, out[sel])
        gap[sel] = torch.minimum(gap[sel], dist)
    return out


def sift_check(img_u8, uv, octave, size, desc, cfg: dict):
    """Per keypoint (N,) bool, True where the reference's descriptor lies
    further than ``max_rel_err`` (L2, relative) from the one under test;
    of the slices a keypoint's size allows, the nearer descriptor counts.
    Returns (bad, relative error)."""
    mats = _sift_mats(uv.device)
    err = torch.full((uv.shape[0],), math.inf, dtype=torch.float32, device=uv.device)
    for level, sel, xy, dist in _sift_groups(img_u8, uv, octave, size, cfg, torch.float32):
        d = sift_describe(level, xy, mats)[1]
        e = torch.linalg.vector_norm(d - desc[sel], dim=-1) / torch.clamp(
            torch.linalg.vector_norm(desc[sel], dim=-1), min=1e-12)
        err[sel] = torch.minimum(err[sel], torch.where(dist <= 0.61, e, torch.full_like(e, math.inf)))
    return err > cfg["max_rel_err"], err
