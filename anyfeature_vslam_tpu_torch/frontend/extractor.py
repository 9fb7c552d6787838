"""orb32 feature extraction (port of anyfeature_vslam_tpu/frontend/extractor.py).

``OrbExtractor`` is the ``detector == "fast"``, ``descriptor == "bin256"``
branch of the JAX ``extract_features``: 8-level pyramid, FAST + 3x3 NMS per
level (kernel K1 on the card, one launch for all levels), grid-spread
top-k, IC angle and steered BRIEF-256 on the blurred level, per-level
budgets and ORB size normalisation. Its constants (resize matrices, Gaussian taps, BRIEF
pattern and sampling tables, moment matrix) are module buffers, so
``.to(device)`` moves them with the module. The registry and config are
copied from the JAX package and held equal to it by a CPU test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from . import brief, cuda_fast, orientation, pyramid, select

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


class OrbExtractor(nn.Module):
    """orb32 extraction for images of one size. ``forward(image)`` takes an
    (H, W) float32 image in 0..255 on the module's device and returns the
    JAX package's feature dict: xy (N, 2), resp, octave (int32), angle,
    size, sigma2, inv_sigma2 (N,) float32, desc_bits (N, 256) uint8 {0,1},
    valid (N,) bool, with N = cfg.capacity."""

    def __init__(self, cfg: ExtractorConfig, height: int, width: int):
        super().__init__()
        if cfg.detector != "fast" or cfg.descriptor != "bin256":
            raise NotImplementedError(
                f"the torch port extracts orb32 (fast + bin256) only; "
                f"{cfg.detector} + {cfg.descriptor} is ROADMAP.md queue item 9, "
                "'The other feature families'"
            )
        self.cfg = cfg
        self.height, self.width = height, width
        self.shapes = pyramid.level_shapes(height, width, cfg.n_levels, cfg.scale_factor)
        for lvl in range(1, cfg.n_levels):
            (h1, w1), (h2, w2) = self.shapes[lvl - 1], self.shapes[lvl]
            self.register_buffer(f"wr{lvl}", torch.from_numpy(pyramid.resize_weights_np(h1, h2)))
            self.register_buffer(f"wc{lvl}", torch.from_numpy(pyramid.resize_weights_np(w1, w2)))
        self.register_buffer("gauss", torch.from_numpy(pyramid.gaussian_kernel1d(cfg.blur_sigma, 3)))
        self.register_buffer("brief_pattern", torch.from_numpy(brief.make_pattern(cfg.desc_dim)))
        p1, p2 = brief.sample_index_tables_np(cfg.desc_dim)
        self.register_buffer("brief_p1", torch.from_numpy(p1))
        self.register_buffer("brief_p2", torch.from_numpy(p2))
        self.register_buffer("moment_mat", torch.from_numpy(orientation.moment_matrix_np()))
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

    def forward(self, image):
        cfg = self.cfg
        image = image.reshape(self.height, self.width)
        levels = [l.contiguous() for l in pyramid.build_pyramid(image, self.resize_mats())]
        # K1 on every level: one launch on the card
        scores = cuda_fast.fast_nms_levels(levels, cfg.detect_th)
        outs = {k: [] for k in ("xy", "resp", "angle", "desc_bits", "valid")}
        for lvl, budget in enumerate(cfg.level_budgets):
            img_l = levels[lvl]
            xy, resp, valid = select.select_spread_topk(scores[lvl], budget, cfg.border)
            # one patch gather from the blurred level serves the IC angle
            # and the BRIEF sampling, as in the JAX package
            img_blur = pyramid.gaussian_blur(img_l, self.gauss)
            flat = orientation.gather_patches(
                img_blur, xy, orientation.PATCH_RADIUS).reshape(budget, -1)
            ang = orientation.ic_angle_from_patches(flat, self.moment_mat)
            desc = brief.describe_from_flat(flat, ang, valid, self.brief_p1, self.brief_p2)
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
