"""Feature extraction (port of anyfeature_vslam_tpu/frontend/extractor.py).

``FeatureExtractor`` is the pyramid branch of the JAX ``extract_features``:
the pyramid, per level a detector (FAST + 3x3 NMS, kernel K1 on the card,
one launch for all levels; or a blob response, ``dog.dog_score_map``:
dog, dog_norm, or SURF's det(Hessian) for surf64, which run no kernel),
grid-spread top-k, then per level one of the descriptors:

  bin256 (any binary width but 384 / 512)
             orb32           IC angle + steered BRIEF, blurred level
  bin384     brisk48         BRISK rings (ringdesc.py), raw level
  bin512     anyfeat_bin     FREAK retina (ringdesc.py), raw level
  learned48  anyfeat_nonbin  IC angle + learned MLP (learned48.py), raw level
  grad48/64/128  surf64 (64)  IC angle + gradient histograms (graddesc.py)

then per-level budgets and ORB size normalisation. ``NonlinearExtractor``
is its ``_extract_nonlinear`` branch (akaze61, kaze64): the FED nonlinear
scale space and det(H) detection (nonlinear.py), then M-LDB 488 bits
(mldb.py) or M-SURF 64-d floats (msurf.py) per evolution level.
``SiftExtractor`` is its ``_extract_sift`` branch (sift128): Gaussian
octaves, 3D DoG extrema with a subpixel fit (scalespace.py), SIFT's
dominant orientation and 4x4x8 histograms (graddesc.py). Neither runs a
CUDA kernel. ``make_extractor`` builds the one a family needs; r2d2_128
loads precomputed features (io/precomputed.py) and has no extractor. The
constants (resize matrices, Gaussian taps, the descriptors' sampling
tables and matrices, moment matrix, MLP) are module state, so
``.to(device)`` moves them with the module. The registry and config are
copied from the JAX package and held equal to it by a CPU test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..convert import learned48_from_numpy
from . import (brief, cuda_fast, dog, graddesc, learned48, mldb, msurf, nonlinear,
               orientation, pyramid, ringdesc, scalespace, select)

ORB_MAX_SIZE = 1.2 ** 7

# name -> (detector, descriptor, n_octaves, scale_factor, detect_th, match_th)
FEATURE_REGISTRY = {
    "orb32": ("fast", "bin256", 8, 1.2, 20.0, 75.0),
    "brisk48": ("fast", "bin384", 8, 1.5, 34.0, 120.0),
    "akaze61": ("akaze", "bin488", 8, 1.1892, 1e-5, 128.0),
    "anyfeat_bin": ("fast", "bin512", 8, 1.2, 20.0, 128.0),
    "sift128": ("sift", "grad128", 8, 2.0, 2.55, 0.5),
    "surf64": ("hessian", "grad64", 8, 1.2, 100.0, 0.12),
    "kaze64": ("kaze", "grad64", 8, 1.1892, 1e-5, 0.1),
    "anyfeat_nonbin": ("fast", "learned48", 8, 1.2, 20.0, 0.62),
    "r2d2_128": ("precomputed", "float128", 1, 2.0, 1.0, 0.38),
}


def descriptor_dim(descriptor: str) -> int:
    if descriptor.startswith("bin"):
        return int(descriptor[3:])
    if descriptor.startswith("grad"):
        return int(descriptor[4:])
    if descriptor.startswith("learned"):
        return int(descriptor[7:])
    return int(descriptor.replace("float", ""))


def descriptor_dtype(descriptor: str):
    return np.uint8 if descriptor.startswith("bin") else np.float32


@dataclass(frozen=True)
class ExtractorConfig:
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    detect_th: float = 20.0
    border: int = 16
    blur_sigma: float = 2.0
    detector: str = "fast"       # fast | dog | dog_norm | hessian
    descriptor: str = "bin256"   # bin256/384/488/512 | grad48/64/128

    @staticmethod
    def for_feature(name: str, n_features: int = 1000) -> "ExtractorConfig":
        det, desc, n_oct, scale, dth, _ = FEATURE_REGISTRY[name]
        if det == "precomputed":
            raise ValueError("r2d2_128 uses the precomputed-feature loader")
        return ExtractorConfig(
            n_features=n_features, n_levels=n_oct, scale_factor=scale,
            detect_th=dth, detector=det, descriptor=desc,
        )

    @property
    def desc_dim(self) -> int:
        return descriptor_dim(self.descriptor)

    @property
    def capacity(self) -> int:
        return sum(self.level_budgets)

    @property
    def level_budgets(self):
        # reference src/FeatureExtractor.cpp:97-108
        factor = 1.0 / self.scale_factor
        desired = self.n_features * (1 - factor) / (1 - factor ** self.n_levels)
        budgets = []
        total = 0
        for _ in range(self.n_levels - 1):
            b = int(round(desired))
            budgets.append(b)
            total += b
            desired *= factor
        budgets.append(max(self.n_features - total, 0))
        return tuple(budgets)

    @property
    def level_scales(self):
        return tuple(self.scale_factor ** l for l in range(self.n_levels))


def _normalized_size_np(cfg: ExtractorConfig):
    """Per-level ORB size in [1, 1.2^7] (reference computeSize,
    src/FeatureExtractor.cpp:132-142), float32 like the JAX package."""
    octave = np.arange(cfg.n_levels, dtype=np.float32)
    raw = np.float32(cfg.scale_factor) ** octave
    max_raw = cfg.scale_factor ** (cfg.n_levels - 1)
    if max_raw <= 1.0 + 1e-6:
        return np.full_like(raw, ORB_MAX_SIZE)
    scaled = (raw - np.float32(1.0)) * np.float32(ORB_MAX_SIZE - 1.0) / np.float32(max_raw - 1.0)
    return (np.float32(1.0) + scaled).astype(np.float32)


_RINGS = {"bin384": "brisk", "bin512": "freak"}
_PYRAMID_DETECTORS = ("fast",) + dog.MODES


class FeatureExtractor(nn.Module):
    """Pyramid-branch extraction for images of one size. ``forward(image)``
    takes an (H, W) float32 image in 0..255 on the module's device and
    returns the JAX package's feature dict: xy (N, 2), resp, octave
    (int32), angle, size, sigma2, inv_sigma2 (N,) float32, desc_bits
    (N, D) uint8 {0,1} (binary) or float32 (learned48, grad*), valid (N,)
    bool, with N = cfg.capacity."""

    def __init__(self, cfg: ExtractorConfig, height: int, width: int):
        super().__init__()
        if cfg.detector not in _PYRAMID_DETECTORS:
            raise ValueError(f"FeatureExtractor takes the detectors {_PYRAMID_DETECTORS}, not "
                             f"{cfg.detector} (make_extractor builds that family's)")
        if not cfg.descriptor.startswith(("bin", "learned48", "grad")):
            raise ValueError(f"no pyramid descriptor {cfg.descriptor}")
        self.cfg = cfg
        self.height, self.width = height, width
        self.shapes = pyramid.level_shapes(height, width, cfg.n_levels, cfg.scale_factor)
        for lvl in range(1, cfg.n_levels):
            (h1, w1), (h2, w2) = self.shapes[lvl - 1], self.shapes[lvl]
            self.register_buffer(f"wr{lvl}", torch.from_numpy(pyramid.resize_weights_np(h1, h2)))
            self.register_buffer(f"wc{lvl}", torch.from_numpy(pyramid.resize_weights_np(w1, w2)))
        blob_taps = () if cfg.detector == "fast" else dog.tensors(cfg.detector)
        self.n_blob_taps = len(blob_taps)
        for k, t in enumerate(blob_taps):
            self.register_buffer(f"blob_taps{k}", t)
        self.register_buffer("moment_mat", torch.from_numpy(orientation.moment_matrix_np()))
        if cfg.descriptor in _RINGS:
            desc_m, ori_m = ringdesc.ring_tensors(_RINGS[cfg.descriptor])
            self.register_buffer("ring_desc", desc_m)
            self.register_buffer("ring_ori", ori_m)
        elif cfg.descriptor.startswith("bin"):
            self.register_buffer("gauss", torch.from_numpy(
                pyramid.gaussian_kernel1d(cfg.blur_sigma, 3)))
            p1, p2 = brief.sample_index_tables_np(cfg.desc_dim)
            self.register_buffer("brief_p1", torch.from_numpy(p1))
            self.register_buffer("brief_p2", torch.from_numpy(p2))
        elif cfg.descriptor == "learned48":
            self.register_buffer("sample_mat", graddesc.sample_tensor())
            self.mlp = learned48_from_numpy(learned48.load_weights(), "cpu")
        else:
            for name, t in zip(("sample_mat", "cell_mat", "rot_cs"), graddesc.tensors()):
                self.register_buffer(name, t)
        size = _normalized_size_np(cfg)
        octave = np.concatenate([np.full(b, l, np.int32) for l, b in enumerate(cfg.level_budgets)])
        self.register_buffer("octave", torch.from_numpy(octave))
        self.register_buffer("size", torch.from_numpy(size[octave]))
        self.register_buffer("level_scale", torch.from_numpy(
            np.concatenate([np.full(b, s, np.float32) for s, b in
                            zip(cfg.level_scales, cfg.level_budgets)])))

    def resize_mats(self):
        return [(getattr(self, f"wr{l}"), getattr(self, f"wc{l}"))
                for l in range(1, self.cfg.n_levels)]

    def describe(self, img_l, xy, valid):
        """(angle (n,), descriptors (n, D)) of one level's keypoints."""
        d = self.cfg.descriptor
        if d in _RINGS:
            return ringdesc.describe_ring(img_l, xy, valid, _RINGS[d], self.ring_desc,
                                          self.ring_ori)
        if d.startswith("bin"):
            # one patch gather from the blurred level serves the IC angle
            # and the BRIEF sampling, as in the JAX package
            img_blur = pyramid.gaussian_blur(img_l, self.gauss)
            flat = orientation.gather_patches(
                img_blur, xy, orientation.PATCH_RADIUS).reshape(xy.shape[0], -1)
            ang = orientation.ic_angle_from_patches(flat, self.moment_mat)
            return ang, brief.describe_from_flat(flat, ang, valid, self.brief_p1, self.brief_p2)
        ang = orientation.ic_angle(img_l, xy, self.moment_mat)
        if d == "learned48":
            return ang, learned48.describe_learned48(img_l, xy, ang, valid, self.sample_mat,
                                                     self.mlp)
        return ang, graddesc.describe_grad(img_l, xy, ang, valid, self.cfg.desc_dim,
                                           self.sample_mat, self.cell_mat, self.rot_cs)

    def forward(self, image):
        return self.from_levels(self.levels(image))

    def levels(self, image):
        """The image's pyramid, one contiguous (H_l, W_l) tensor per level."""
        image = image.reshape(self.height, self.width)
        return [l.contiguous() for l in pyramid.build_pyramid(image, self.resize_mats())]

    def from_levels(self, levels):
        """The feature dict of ``forward`` from the pyramid's levels."""
        cfg = self.cfg
        if cfg.detector == "fast":
            # K1 on every level: one launch on the card
            scores = cuda_fast.fast_nms_levels(levels, cfg.detect_th)
        else:
            taps = [getattr(self, f"blob_taps{k}") for k in range(self.n_blob_taps)]
            scores = [dog.dog_score_map(l, cfg.detect_th, cfg.detector, taps) for l in levels]
        outs = {k: [] for k in ("xy", "resp", "angle", "desc_bits", "valid")}
        for lvl, budget in enumerate(cfg.level_budgets):
            xy, resp, valid = select.select_spread_topk(scores[lvl], budget, cfg.border)
            ang, desc = self.describe(levels[lvl], xy, valid)
            outs["xy"].append(xy)
            outs["resp"].append(resp)
            outs["angle"].append(ang)
            outs["desc_bits"].append(desc)
            outs["valid"].append(valid)
        valid = torch.cat(outs["valid"])
        sigma2 = self.size * self.size
        return dict(
            xy=torch.cat(outs["xy"]) * self.level_scale[:, None],
            resp=torch.cat(outs["resp"]),
            octave=self.octave,
            angle=torch.cat(outs["angle"]),
            size=self.size,
            sigma2=sigma2,
            inv_sigma2=torch.where(valid, 1.0 / sigma2, torch.zeros_like(sigma2)),
            desc_bits=torch.cat(outs["desc_bits"]),
            valid=valid,
        )


# the orb32 extractor's earlier name
OrbExtractor = FeatureExtractor


class NonlinearExtractor(nn.Module):
    """akaze61 / kaze64 extraction for images of one size (the JAX
    ``_extract_nonlinear``): the nonlinear scale space of image / 255,
    det(H) maxima over space and the adjacent levels above
    ``cfg.detect_th``, spread top-k per evolution level, then the main
    orientation and M-LDB bits (akaze) or M-SURF floats (kaze). AKAZE
    halves the resolution per octave; KAZE keeps it and describes octaves
    >= 1 on Lx, Ly decimated by 2^octave. The stored ``octave`` is the
    true octave (0..omax-1), which matching-level gates read; the size
    comes from the evolution index (reference src/Feature_akaze61.cpp:
    63-69). ``forward`` returns ``FeatureExtractor``'s dict."""

    def __init__(self, cfg: ExtractorConfig, height: int, width: int):
        super().__init__()
        if cfg.detector not in _NONLINEAR:
            raise ValueError(f"NonlinearExtractor takes the akaze / kaze detectors, not "
                             f"{cfg.detector}")
        self.cfg = cfg
        self.height, self.width = height, width
        self.downsample = cfg.detector == "akaze"
        plans = nonlinear.plan_levels(height, width, cfg.n_levels, self.downsample)
        # KAZE describes octave o >= 1 on maps decimated by f = 2^o
        self.decimate = {}
        if not self.downsample:
            for p in plans:
                f = 2 ** p.octave
                if f > 1:
                    self.decimate[p.index] = (f, max(height // f, 16), max(width // f, 16))
        extra = {(n, m) for _, h2, w2 in self.decimate.values()
                 for n, m in ((height, h2), (width, w2))}
        self.consts = nonlinear.Constants(height, width, cfg.n_levels, self.downsample,
                                          extra=extra)
        # one set of descriptor matrices per distinct level scale (4 per family)
        self.level_scale, self.level_key, keys = [], [], {}
        for p in plans:
            scale = p.sigma_rel if p.index not in self.decimate else (
                p.sigma / self.decimate[p.index][0])
            patch = (mldb.patch_radius if self.downsample else msurf.patch_radius)(scale)
            k = (round(scale, 4), patch)
            if k not in keys:
                keys[k] = len(keys)
                mats = mldb.tensors(scale) if self.downsample else msurf.tensors(scale)
                for name, t in zip(("ori", "desc"), mats):
                    self.register_buffer(f"{name}{keys[k]}", t)
            self.level_scale.append(scale)
            self.level_key.append(keys[k])
        if self.downsample:
            self.register_buffer("pairs", mldb.pair_indices())
        else:
            self.register_buffer("cell_w", msurf.cell_weight_tensor())
        size = _normalized_size_np(cfg)  # by evolution index
        budgets = cfg.level_budgets
        self.register_buffer("octave", torch.from_numpy(np.concatenate(
            [np.full(b, p.octave, np.int32) for p, b in zip(plans, budgets)])))
        self.register_buffer("size", torch.from_numpy(np.concatenate(
            [np.full(b, size[p.index], np.float32) for p, b in zip(plans, budgets)])))
        self.register_buffer("up", torch.from_numpy(np.concatenate(
            [np.full(b, 2.0 ** p.octave if self.downsample else 1.0, np.float32)
             for p, b in zip(plans, budgets)])))

    def describe(self, ev, xy, valid):
        """(angle (n,), descriptors (n, D)) of one evolution level's
        keypoints xy in level pixels."""
        key = self.level_key[ev.index]
        ori_m, desc_m = getattr(self, f"ori{key}"), getattr(self, f"desc{key}")
        scale = self.level_scale[ev.index]
        if self.downsample:
            return mldb.describe_mldb(ev.L, ev.Lx, ev.Ly, xy, valid, scale, ori_m, desc_m,
                                      self.pairs)
        gx, gy, dxy = ev.Lx, ev.Ly, xy
        if ev.index in self.decimate:
            # decimate the (already sigma >= 2^o smoothed) derivative maps
            # so the descriptor's sampling matrices stay bounded
            f, h2, w2 = self.decimate[ev.index]
            gx, gy = self.consts.resize(gx, h2, w2), self.consts.resize(gy, h2, w2)
            dxy = xy / f
        return msurf.describe_kaze(gx, gy, dxy, valid, scale, ori_m, desc_m, self.cell_w)

    def forward(self, image):
        return self.from_levels(self.levels(image))

    def levels(self, image):
        """The nonlinear scale space of an (H, W) float32 image in 0..255."""
        img01 = image.reshape(self.height, self.width) * (1.0 / 255.0)
        return nonlinear.build_evolution(img01, self.consts)

    def from_levels(self, levels):
        """The feature dict of ``forward`` from the scale space's levels."""
        cfg = self.cfg
        scores = nonlinear.detect_scores(levels, self.consts)
        outs = {k: [] for k in ("xy", "resp", "angle", "desc_bits", "valid")}
        for ev, smap, budget in zip(levels, scores, cfg.level_budgets):
            smap = torch.where(smap > cfg.detect_th, smap, torch.zeros_like(smap))
            # the border scales with the level's own resolution
            border = max(cfg.border // (2 ** ev.octave if self.downsample else 1), 6)
            xy, resp, valid = select.select_spread_topk(smap, budget, border)
            ang, desc = self.describe(ev, xy, valid)
            outs["xy"].append(xy)
            outs["resp"].append(resp)
            outs["angle"].append(ang)
            outs["desc_bits"].append(desc)
            outs["valid"].append(valid)
        valid = torch.cat(outs["valid"])
        sigma2 = self.size * self.size
        return dict(
            xy=torch.cat(outs["xy"]) * self.up[:, None],
            resp=torch.cat(outs["resp"]),
            octave=self.octave,
            angle=torch.cat(outs["angle"]),
            size=self.size,
            sigma2=sigma2,
            inv_sigma2=torch.where(valid, 1.0 / sigma2, torch.zeros_like(sigma2)),
            desc_bits=torch.cat(outs["desc_bits"]),
            valid=valid,
        )


_NONLINEAR = ("akaze", "kaze")


def _sift_unit_budgets(total: int, n_units: int, nspo: int):
    """Geometric per-(octave, slice) budgets summing EXACTLY to `total`
    (the frame SoA capacity), finer scales first — same shape as the
    reference per-level split (src/FeatureExtractor.cpp:97-108) over the
    continuous-scale units."""
    factor = 0.5 ** (1.0 / nspo)
    desired = total * (1 - factor) / (1 - factor ** n_units)
    budgets = []
    acc = 0
    for u in range(n_units - 1):
        b = max(min(int(round(desired)), total - acc - (n_units - 1 - u)), 1)
        budgets.append(b)
        acc += b
        desired *= factor
    budgets.append(total - acc)
    return budgets


class SiftExtractor(nn.Module):
    """sift128 extraction for images of one size (the JAX
    ``_extract_sift``; reference src/Feature_sift128.cpp:9-92): nspo =
    n_levels / 4 slices per octave and as many octaves as the image
    allows (at most n_levels / nspo; 4 at 640x480, 3 at 320x240), one
    unit per (octave, inner DoG slice) with a static slice of the
    capacity as its budget. Per unit the 3D DoG extrema
    (``scalespace.dog_extrema_maps``), spread top-k, the keypoints moved
    by the subpixel offsets read at their integer maxima, then SIFT's
    dominant orientation and 4x4x8 histograms on the unit's Gaussian
    slice (``graddesc.describe_grad_auto``). The stored octave is the
    unit's octave; the size is the refined continuous scale mapped onto
    ORB's band. ``forward`` returns ``FeatureExtractor``'s dict."""

    def __init__(self, cfg: ExtractorConfig, height: int, width: int):
        super().__init__()
        if cfg.detector != "sift":
            raise ValueError(f"SiftExtractor takes the sift detector, not {cfg.detector}")
        self.cfg = cfg
        self.height, self.width = height, width
        self.nspo = nspo = max(cfg.n_levels // 4, 1)
        self.n_oct = n_oct = scalespace.n_octaves(height, width,
                                                  max_octaves=max(cfg.n_levels // nspo, 1))
        self.budgets = _sift_unit_budgets(cfg.capacity, n_oct * nspo, nspo)
        self.sig = scalespace.slice_sigmas(nspo)
        self.register_buffer("base_taps", scalespace.taps(scalespace.base_sigma()))
        self.n_inc = nspo + 2
        for k, s in enumerate(scalespace.increment_sigmas(nspo)):
            self.register_buffer(f"inc_taps{k}", scalespace.taps(s))
        self.shapes = [(height, width)]
        for o in range(1, n_oct):
            (h1, w1), (h2, w2) = self.shapes[-1], scalespace.octave_shape(*self.shapes[-1])
            self.register_buffer(f"wr{o}", torch.from_numpy(pyramid.resize_weights_np(h1, h2)))
            self.register_buffer(f"wc{o}", torch.from_numpy(pyramid.resize_weights_np(w1, w2)))
            self.shapes.append((h2, w2))
        for name, t in zip(("sample_mat", "cell_mat", "rot_cs", "ori_w"), graddesc.tensors()):
            self.register_buffer(name, t)
        units = [o for o in range(n_oct) for _ in range(nspo)]
        self.register_buffer("octave", torch.from_numpy(np.concatenate(
            [np.full(b, o, np.int32) for o, b in zip(units, self.budgets)])))
        self.register_buffer("up", torch.from_numpy(np.concatenate(
            [np.full(b, 2.0 ** o, np.float32) for o, b in zip(units, self.budgets)])))
        # the continuous size's band: sizes up to 0.6 slices past the last unit
        self.max_raw = (self.sig[nspo] / scalespace.SIGMA0) * (2.0 ** (n_oct - 1)) * 2.0 ** 0.6
        # a divisor on the device: CUDA multiplies by the reciprocal of a host scalar
        self.register_buffer("size_div", torch.tensor(self.max_raw - 1.0, dtype=torch.float32))

    def forward(self, image):
        return self.from_levels(self.levels(image))

    def levels(self, image):
        """The Gaussian scale space of an (H, W) float32 image in 0..255:
        per octave its nspo + 3 slices."""
        image = image.reshape(self.height, self.width)
        inc = [getattr(self, f"inc_taps{k}") for k in range(self.n_inc)]
        base = pyramid.gaussian_blur(image, self.base_taps)
        octaves = []
        for o in range(self.n_oct):
            if o > 0:
                base = scalespace.downsample2(octaves[-1][self.nspo], getattr(self, f"wr{o}"),
                                              getattr(self, f"wc{o}"))
            octaves.append(scalespace.build_octave(base, inc))
        return octaves

    def from_levels(self, octaves):
        """The feature dict of ``forward`` from the scale space's octaves."""
        cfg, nspo = self.cfg, self.nspo
        outs = {k: [] for k in ("xy", "resp", "angle", "desc_bits", "valid", "raw")}
        unit = 0
        for o, slices in enumerate(octaves):
            dogs = [slices[i + 1] - slices[i] for i in range(nspo + 2)]
            lh, lw = slices[0].shape
            border = max(min(cfg.border, min(lh, lw) // 4), 4)
            for i in range(1, nspo + 1):
                score, ox, oy, osc = scalespace.dog_extrema_maps(
                    dogs[i - 1], dogs[i], dogs[i + 1], cfg.detect_th)
                xy, resp, valid = select.select_spread_topk(score, self.budgets[unit], border)
                xi = torch.clamp(xy[:, 0].to(torch.int64), 0, lw - 1)
                yi = torch.clamp(xy[:, 1].to(torch.int64), 0, lh - 1)
                xy_ref = xy + torch.stack([ox[yi, xi], oy[yi, xi]], -1)
                ang, desc = graddesc.describe_grad_auto(
                    slices[i], xy_ref, valid, cfg.desc_dim, self.sample_mat, self.cell_mat,
                    self.rot_cs, self.ori_w)
                outs["xy"].append(xy_ref)
                outs["resp"].append(resp)
                outs["angle"].append(ang)
                outs["desc_bits"].append(desc)
                outs["valid"].append(valid)
                # the refined continuous scale sigma0 * 2^(o + (i + ds) / nspo),
                # relative to sigma0
                outs["raw"].append((self.sig[i] / scalespace.SIGMA0)
                                   * (2.0 ** (o + osc[yi, xi] / nspo)))
                unit += 1
        valid = torch.cat(outs["valid"])
        # the continuous size onto ORB's [1, 1.2^7] band (computeSize,
        # src/FeatureExtractor.cpp:132-142)
        raw = torch.clamp(torch.cat(outs["raw"]), 1.0, self.max_raw)
        size = 1.0 + (raw - 1.0) * (ORB_MAX_SIZE - 1.0) / self.size_div
        sigma2 = size * size
        return dict(
            xy=torch.cat(outs["xy"]) * self.up[:, None],
            resp=torch.cat(outs["resp"]),
            octave=self.octave,
            angle=torch.cat(outs["angle"]),
            size=size,
            sigma2=sigma2,
            inv_sigma2=torch.where(valid, 1.0 / sigma2, torch.zeros_like(sigma2)),
            desc_bits=torch.cat(outs["desc_bits"]),
            valid=valid,
        )


def make_extractor(cfg: ExtractorConfig, height: int, width: int):
    """The extractor of cfg's family: ``NonlinearExtractor`` for the akaze /
    kaze detectors, ``SiftExtractor`` for sift, else ``FeatureExtractor``
    (the pyramid branch). The precomputed detector (r2d2_128) has none:
    the tracker loads its features (io/precomputed.py)."""
    if cfg.detector == "precomputed":
        raise ValueError("precomputed features are loaded, not extracted "
                         "(io/precomputed.load_precomputed_features)")
    if cfg.detector in _NONLINEAR:
        return NonlinearExtractor(cfg, height, width)
    if cfg.detector == "sift":
        return SiftExtractor(cfg, height, width)
    return FeatureExtractor(cfg, height, width)
