"""Sub-profile the tracked frame: extraction (keypoints, angles,
descriptors), the guided search and the pose LM. Port of
tools/profile_tracking.py on the port's modules (the orb32 extractor with
K1, ``matching.guided_best_two`` with K2, ``pose_opt.pose_optimize``;
``flagship.make_example``'s map points and pose) over a batch of random
640x480 frames.

    python -m anyfeature_vslam_tpu_torch.tools.profile_tracking [n_frames:64] [device:cuda]

Stages, each cumulative, timed after a warm call, the best of 3 passes
over the batch, printed as ms per frame beside the card's name and power
limit (CUDA events on the card, time.perf_counter on the CPU): xy (the
pyramid, K1, select), angle (+ the IC angles), desc (the whole
extraction), match (+ the guided search), pose (+ matching's finish and
the pose LM: ``flagship.tracking_step``).
"""

from __future__ import annotations

import sys

from ..run_mono import parse_args
from ._timing import best_ms, card_label

STAGES = ("xy", "angle", "desc", "match", "pose")


def stage_fn(stage, ext, example):
    """One frame through `stage`: (H, W) image tensor -> a scalar tensor."""
    import torch

    from .. import flagship
    from ..frontend import cuda_fast, orientation, pyramid, select
    from ..ops import matching
    from ..slam.frame_ops import MAX_SIZE

    cfg = ext.cfg
    _, bits, uv, size, valid, pts3d, t_init, fx, fy, cx, cy = example

    def keypoints(im):
        levels = ext.levels(im)
        scores = cuda_fast.fast_nms_levels(levels, cfg.detect_th)
        return levels, [select.select_spread_topk(scores[lvl], budget, cfg.border)
                        for lvl, budget in enumerate(cfg.level_budgets)]

    def run(im):
        if stage in ("xy", "angle"):
            levels, picked = keypoints(im)
            acc = sum(xy.sum() for xy, _, _ in picked)
            if stage == "angle":
                for lvl, (xy, _, _) in enumerate(picked):
                    blur = pyramid.gaussian_blur(levels[lvl], ext.gauss)
                    flat = orientation.gather_patches(blur, xy, orientation.PATCH_RADIUS)
                    acc = acc + orientation.ic_angle_from_patches(
                        flat.reshape(xy.shape[0], -1), ext.moment_mat).sum()
            return acc
        if stage == "pose":
            return flagship.tracking_step(im, bits, uv, size, valid, pts3d, t_init, fx, fy,
                                          cx, cy, extractor=ext)[0].sum()
        feats = ext(im)
        if stage == "desc":
            return feats["xy"].sum() + feats["desc_bits"].to(torch.float32).sum()
        radius = 15.0 * matching.RADIUS_SCALE * torch.clamp(size, 1.0, MAX_SIZE)
        best, _, _ = matching.guided_best_two(
            bits, feats["desc_bits"], uv, feats["xy"],
            torch.where(valid, radius, torch.full_like(radius, -1.0)), size / 1.5, size * 1.5,
            feats["size"], feats["valid"])
        return best.sum()
    return run


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    import numpy as np
    import torch

    from .. import flagship
    from ..frontend.extractor import ExtractorConfig, FeatureExtractor

    device = torch.device(args.get("device", "cuda"))
    n = int(args.get("n_frames", 64))
    ext = FeatureExtractor(ExtractorConfig(n_features=1000), 480, 640).to(device)
    example = flagship.example_on(device, 480, 640)
    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.uniform(0, 255, (n, 480, 640)).astype(np.float32)).to(device)
    card = card_label(device)
    with torch.no_grad():
        for st in STAGES:
            fn = stage_fn(st, ext, example)
            best = best_ms(lambda: [fn(im) for im in batch], device)
            print(st, round(best / n, 3), "ms/frame", f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
