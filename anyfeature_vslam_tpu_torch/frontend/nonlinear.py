"""Nonlinear diffusion scale space with FED stepping, and its det(H)
detector (port of anyfeature_vslam_tpu/frontend/nonlinear.py).

The AKAZE / KAZE scale space: evolution levels (octave o, sublevel j) at
sigma = s0 * 2^(o + j/S); between levels, Fast Explicit Diffusion cycles of
the Perona-Malik g2 conductivity with the contrast factor k (the 70th
percentile of the smoothed image's gradient magnitudes, by a 300-bin
histogram); per level the sigma-scaled dilated-Scharr derivatives and the
scale-normalized det(Hessian). AKAZE halves the resolution per octave
(``downsample=True``), KAZE stays at full resolution. Detection is 3x3
spatial NMS plus a point-to-point scale non-max against the adjacent
levels, resampled where their resolutions differ.

Plain PyTorch in the JAX package's expression order: the step counts and
level shapes are Python ints fixed at construction (``Constants``), each
FED step is a few elementwise ops over edge-replicated shifts, and the
contrast factor stays a device scalar. The resize products (octave
halving, cross-level resampling) are fp32 ``wr @ (L @ wc.T)`` as in JAX,
summed in another order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
from torch import nn

from . import pyramid
from .fast import nms3x3

TAU_MAX = 0.25          # 2D explicit-diffusion stability limit
SIGMA0 = 1.6            # base scale (libAKAZE soffset)
K_PERCENTILE = 0.7      # contrast factor percentile (libAKAZE kpercentile)
K_NBINS = 300           # histogram bins for the percentile estimate

_SMOOTH = (1.0, 2)      # (sigma, radius) of the contrast / conductivity blur


def fed_tau_steps(total_time: float, tau_max: float = TAU_MAX):
    """FED step sizes covering `total_time` (Python floats).

    n is the smallest step count whose FED cycle time tau_max*n*(n+1)/3
    reaches total_time; the raw cosine schedule is then rescaled to sum to
    total_time exactly (scaling down preserves stability).
    """
    if total_time <= 0.0:
        return []
    n = max(1, int(math.ceil(0.5 * (math.sqrt(1.0 + 12.0 * total_time / tau_max) - 1.0))))
    taus = [
        tau_max / (2.0 * math.cos(math.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
        for j in range(n)
    ]
    s = sum(taus)
    return [t * total_time / s for t in taus]


def _shift(img, dy: int, dx: int):
    """out[y, x] = img[clip(y + dy), clip(x + dx)], edge replicated."""
    h, w = img.shape
    if dy > 0:
        img = torch.cat([img[dy:], img[-1:].expand(dy, w)], 0)
    elif dy < 0:
        img = torch.cat([img[:1].expand(-dy, w), img[:h + dy]], 0)
    if dx > 0:
        img = torch.cat([img[:, dx:], img[:, -1:].expand(h, dx)], 1)
    elif dx < 0:
        img = torch.cat([img[:, :1].expand(h, -dx), img[:, :w + dx]], 1)
    return img


def _gradient_sq(smooth):
    gx = 0.5 * (_shift(smooth, 0, 1) - _shift(smooth, 0, -1))
    gy = 0.5 * (_shift(smooth, 1, 0) - _shift(smooth, -1, 0))
    return gx * gx + gy * gy


def contrast_factor(img01, taps):
    """Contrast factor k, a 0-d device tensor: the K_PERCENTILE quantile of
    the gradient magnitude of the sigma=1 smoothed image, by a 300-bin
    histogram (libAKAZE Compute_K_Percentile). taps: the sigma=1 blur
    taps (``Constants.smooth``)."""
    mag = torch.sqrt(_gradient_sq(pyramid.gaussian_blur(img01, taps)))
    # interior only (edge-replicated borders have zero gradient bias)
    mag = mag[1:-1, 1:-1].reshape(-1)
    hmax = torch.max(mag) + 1e-12
    idx = torch.clamp((mag / hmax * K_NBINS).to(torch.int64), 0, K_NBINS - 1)
    # integer counts: exact, and the same on every device
    hist = torch.zeros(K_NBINS, dtype=torch.int64, device=mag.device)
    hist.index_add_(0, idx, (mag > 0).to(torch.int64))
    csum = torch.cumsum(hist, 0).to(torch.float32)
    bin_i = torch.argmax((csum >= K_PERCENTILE * csum[-1]).to(torch.int32))  # the first
    # a divisor on the device: CUDA multiplies by the reciprocal of a host scalar
    k = hmax * (bin_i.to(torch.float32) + 0.5) / torch.full((), K_NBINS, dtype=torch.float32,
                                                             device=mag.device)
    return torch.clamp(k, min=1e-3)


def _conductivity(L, k2, taps):
    """Perona-Malik g2 on the sigma=1 smoothed current level."""
    return 1.0 / (1.0 + _gradient_sq(pyramid.gaussian_blur(L, taps)) / k2)


def _fed_cycle(L, g, taus):
    """Explicit diffusion steps L += tau * div(g grad L) on the
    4-neighbourhood, the conductivity held over the cycle."""
    g_e = g + _shift(g, 0, 1)    # x+1 half-point conductivity (x2)
    g_w = g + _shift(g, 0, -1)
    g_s = g + _shift(g, 1, 0)
    g_n = g + _shift(g, -1, 0)
    for tau in taus:
        flux = (
            g_e * (_shift(L, 0, 1) - L)
            + g_w * (_shift(L, 0, -1) - L)
            + g_s * (_shift(L, 1, 0) - L)
            + g_n * (_shift(L, -1, 0) - L)
        )
        L = L + (0.5 * tau) * flux
    return L


# Scharr 3x3 first-derivative weights: d/dx = [[-3,0,3],[-10,0,10],[-3,0,3]]
# / 32, applied with a dilation step for scale
_SCHARR_EDGE = 3.0 / 32.0
_SCHARR_MID = 10.0 / 32.0


def scharr_x(img, step: int = 1):
    t = _shift(img, -step, 0)
    m = img
    b = _shift(img, step, 0)
    return (
        _SCHARR_EDGE * (_shift(t, 0, step) - _shift(t, 0, -step))
        + _SCHARR_MID * (_shift(m, 0, step) - _shift(m, 0, -step))
        + _SCHARR_EDGE * (_shift(b, 0, step) - _shift(b, 0, -step))
    )


def scharr_y(img, step: int = 1):
    l = _shift(img, 0, -step)
    m = img
    r = _shift(img, 0, step)
    return (
        _SCHARR_EDGE * (_shift(l, step, 0) - _shift(l, -step, 0))
        + _SCHARR_MID * (_shift(m, step, 0) - _shift(m, -step, 0))
        + _SCHARR_EDGE * (_shift(r, step, 0) - _shift(r, -step, 0))
    )


@dataclass(frozen=True)
class EvolutionLevel:
    """One nonlinear scale-space slice: static metadata and tensors."""
    octave: int
    sublevel: int
    index: int
    sigma: float          # full-resolution scale
    sigma_rel: float      # scale in this level's own pixel units
    L: torch.Tensor       # diffused image (h, w)
    Lx: torch.Tensor      # sigma-scaled first derivatives
    Ly: torch.Tensor
    response: torch.Tensor  # scale-normalized det(Hessian)

    def to(self, device):
        return replace(self, L=self.L.to(device), Lx=self.Lx.to(device),
                       Ly=self.Ly.to(device), response=self.response.to(device))


@dataclass(frozen=True)
class LevelPlan:
    """The static part of one evolution level."""
    octave: int
    sublevel: int
    index: int
    sigma: float
    sigma_rel: float
    step: int             # Scharr dilation
    taus: tuple           # FED steps from the previous level (none for level 0)
    shape: tuple          # (h, w) of the level


def plan_levels(height: int, width: int, n_levels: int = 8, downsample: bool = True,
                sigma0: float = SIGMA0):
    """The levels of ``build_evolution`` as Python numbers: omax = n_levels/S
    octaves of S = n_levels/2 sublevels (reference src/Feature_akaze61.cpp:
    10-11), the FED steps in each octave's own pixel units."""
    S = max(n_levels // 2, 1)
    omax = max(n_levels // S, 1)
    assert omax * S == n_levels, (omax, S, n_levels)
    plans = []
    h, w = height, width
    t_prev = 0.5 * sigma0 * sigma0
    idx = 0
    for o in range(omax):
        scale_div = float(2 ** o)
        if o > 0 and downsample:
            h, w = max(h // 2, 16), max(w // 2, 16)
        for j in range(S):
            sigma = sigma0 * (2.0 ** (o + j / S))
            t = 0.5 * sigma * sigma
            taus = ()
            if idx > 0:
                div = scale_div ** 2 if downsample else 1.0
                taus = tuple(fed_tau_steps((t - t_prev) / div))
            sigma_rel = sigma / scale_div if downsample else sigma
            plans.append(LevelPlan(o, j, idx, sigma, sigma_rel, max(1, int(round(sigma_rel))),
                                   taus, (h, w)))
            t_prev = t
            idx += 1
    return plans


class Constants(nn.Module):
    """The constants of one image size's scale space as buffers, so
    ``.to(device)`` moves them: the blur taps, the resize matrices of the
    octave halving and of the cross-level resampling (``mat(n_in,
    n_out)``), plus any ``extra`` (n_in, n_out) pairs a caller needs."""

    def __init__(self, height: int, width: int, n_levels: int = 8, downsample: bool = True,
                 sigma0: float = SIGMA0, extra=()):
        super().__init__()
        self.plans = plan_levels(height, width, n_levels, downsample, sigma0)
        self.downsample = downsample
        self.register_buffer("base", torch.from_numpy(
            pyramid.gaussian_kernel1d(sigma0, max(2, int(3 * sigma0)))))
        self.register_buffer("smooth", torch.from_numpy(pyramid.gaussian_kernel1d(*_SMOOTH)))
        pairs = set(extra)
        shapes = [p.shape for p in self.plans]
        for a, b in zip(shapes[:-1], shapes[1:]):
            if a != b:  # octave halving, and resampling both ways
                pairs |= {(a[0], b[0]), (a[1], b[1]), (b[0], a[0]), (b[1], a[1])}
        for n_in, n_out in sorted(pairs):
            self.register_buffer(f"resize_{n_in}_{n_out}", torch.from_numpy(
                pyramid.resize_weights_np(n_in, n_out)))

    def mat(self, n_in: int, n_out: int):
        return getattr(self, f"resize_{n_in}_{n_out}")

    def resize(self, arr, h2: int, w2: int):
        """arr resampled to (h2, w2), in the JAX order wr @ (arr @ wc.T)."""
        h, w = arr.shape
        if (h, w) == (h2, w2):
            return arr
        return self.mat(h, h2) @ (arr @ self.mat(w, w2).T)


def build_evolution(img01, consts: Constants):
    """The nonlinear scale space of an (H, W) float32 image in [0, 1]: a
    list of EvolutionLevel, one per ``consts.plans`` entry (``consts`` on
    the image's device)."""
    k = contrast_factor(img01, consts.smooth)
    k2 = k * k
    levels = []
    L = pyramid.gaussian_blur(img01, consts.base)
    for p in consts.plans:
        if tuple(L.shape) != p.shape:
            L = consts.resize(L, *p.shape)
        if p.taus:
            L = _fed_cycle(L, _conductivity(L, k2, consts.smooth), p.taus)
        lx = scharr_x(L, p.step) * p.sigma_rel
        ly = scharr_y(L, p.step) * p.sigma_rel
        lxx = scharr_x(lx, p.step) * p.sigma_rel
        lyy = scharr_y(ly, p.step) * p.sigma_rel
        lxy = scharr_y(lx, p.step) * p.sigma_rel
        resp = lxx * lyy - lxy * lxy
        levels.append(EvolutionLevel(
            octave=p.octave, sublevel=p.sublevel, index=p.index, sigma=p.sigma,
            sigma_rel=p.sigma_rel, L=L, Lx=lx, Ly=ly, response=resp))
    return levels


def detect_scores(levels, consts: Constants):
    """Per-level detection score maps: 3x3 spatial NMS of det(H), then the
    scale non-max against the adjacent evolution levels (resampled where
    the resolutions differ). Returns a list of (h, w) maps."""
    out = []
    n = len(levels)
    for i, lv in enumerate(levels):
        h, w = lv.response.shape
        score = nms3x3(lv.response)
        for nb in (i - 1, i + 1):
            if 0 <= nb < n:
                neighbor = consts.resize(levels[nb].response, h, w)
                score = torch.where(score >= neighbor, score, torch.zeros_like(score))
        out.append(score)
    return out
