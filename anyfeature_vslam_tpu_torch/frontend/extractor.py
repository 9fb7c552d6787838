"""Feature extraction of the FAST families (port of
anyfeature_vslam_tpu/frontend/extractor.py).

``FeatureExtractor`` is the ``detector == "fast"`` branch of the JAX
``extract_features``: the pyramid, FAST + 3x3 NMS per level (kernel K1 on
the card, one launch for all levels), grid-spread top-k, then per level
one of four descriptors:

  bin256     orb32           IC angle + steered BRIEF-256, blurred level
  bin384     brisk48         BRISK rings (ringdesc.py), raw level
  bin512     anyfeat_bin     FREAK retina (ringdesc.py), raw level
  learned48  anyfeat_nonbin  IC angle + learned MLP (learned48.py), raw level

then per-level budgets and ORB size normalisation. Its constants (resize
matrices, Gaussian taps, the descriptor's sampling tables or matrices,
moment matrix, MLP) are module state, so ``.to(device)`` moves them with
the module. The other detectors (akaze61, kaze64, sift128, surf64) raise
``NotImplementedError`` naming ROADMAP.md queue item 9. The registry and
config are copied from the JAX package and held equal to it by a CPU
test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..convert import learned48_from_numpy
from . import brief, cuda_fast, learned48, orientation, pyramid, ringdesc, select

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
_DESCRIPTORS = ("bin256", "bin384", "bin512", "learned48")


class FeatureExtractor(nn.Module):
    """FAST-family extraction for images of one size. ``forward(image)``
    takes an (H, W) float32 image in 0..255 on the module's device and
    returns the JAX package's feature dict: xy (N, 2), resp, octave
    (int32), angle, size, sigma2, inv_sigma2 (N,) float32, desc_bits
    (N, D) uint8 {0,1} (binary) or float32 (learned48), valid (N,) bool,
    with N = cfg.capacity."""

    def __init__(self, cfg: ExtractorConfig, height: int, width: int):
        super().__init__()
        if cfg.detector != "fast" or cfg.descriptor not in _DESCRIPTORS:
            raise NotImplementedError(
                f"the torch port extracts the FAST families (orb32, brisk48, anyfeat_bin, "
                f"anyfeat_nonbin) only; {cfg.detector} + {cfg.descriptor} is ROADMAP.md "
                "queue item 9, 'The other feature families'"
            )
        self.cfg = cfg
        self.height, self.width = height, width
        self.shapes = pyramid.level_shapes(height, width, cfg.n_levels, cfg.scale_factor)
        for lvl in range(1, cfg.n_levels):
            (h1, w1), (h2, w2) = self.shapes[lvl - 1], self.shapes[lvl]
            self.register_buffer(f"wr{lvl}", torch.from_numpy(pyramid.resize_weights_np(h1, h2)))
            self.register_buffer(f"wc{lvl}", torch.from_numpy(pyramid.resize_weights_np(w1, w2)))
        self.register_buffer("moment_mat", torch.from_numpy(orientation.moment_matrix_np()))
        if cfg.descriptor == "bin256":
            self.register_buffer("gauss", torch.from_numpy(
                pyramid.gaussian_kernel1d(cfg.blur_sigma, 3)))
            p1, p2 = brief.sample_index_tables_np(cfg.desc_dim)
            self.register_buffer("brief_p1", torch.from_numpy(p1))
            self.register_buffer("brief_p2", torch.from_numpy(p2))
        elif cfg.descriptor in _RINGS:
            desc_m, ori_m = ringdesc.ring_tensors(_RINGS[cfg.descriptor])
            self.register_buffer("ring_desc", desc_m)
            self.register_buffer("ring_ori", ori_m)
        else:
            self.register_buffer("sample_mat", learned48.sample_tensor())
            self.mlp = learned48_from_numpy(learned48.load_weights(), "cpu")
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
        if d == "bin256":
            # one patch gather from the blurred level serves the IC angle
            # and the BRIEF sampling, as in the JAX package
            img_blur = pyramid.gaussian_blur(img_l, self.gauss)
            flat = orientation.gather_patches(
                img_blur, xy, orientation.PATCH_RADIUS).reshape(xy.shape[0], -1)
            ang = orientation.ic_angle_from_patches(flat, self.moment_mat)
            return ang, brief.describe_from_flat(flat, ang, valid, self.brief_p1, self.brief_p2)
        if d in _RINGS:
            return ringdesc.describe_ring(img_l, xy, valid, _RINGS[d], self.ring_desc,
                                          self.ring_ori)
        ang = orientation.ic_angle(img_l, xy, self.moment_mat)
        return ang, learned48.describe_learned48(img_l, xy, ang, valid, self.sample_mat,
                                                 self.mlp)

    def forward(self, image):
        return self.from_levels(self.levels(image))

    def levels(self, image):
        """The image's pyramid, one contiguous (H_l, W_l) tensor per level."""
        image = image.reshape(self.height, self.width)
        return [l.contiguous() for l in pyramid.build_pyramid(image, self.resize_mats())]

    def from_levels(self, levels):
        """The feature dict of ``forward`` from the pyramid's levels."""
        cfg = self.cfg
        # K1 on every level: one launch on the card
        scores = cuda_fast.fast_nms_levels(levels, cfg.detect_th)
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

