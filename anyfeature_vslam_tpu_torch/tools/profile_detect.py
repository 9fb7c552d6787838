"""Sub-profile the detection stage: pyramid vs FAST+NMS vs select. Port of
tools/profile_detect.py on the port's modules: the orb32 extractor's
pyramid, K1 (``cuda_fast.fast_nms_levels``, every level in one launch; the
plain twin on the CPU) and the spread top-k, over a batch of random
640x480 frames.

    python -m anyfeature_vslam_tpu_torch.tools.profile_detect [n_frames:64] [device:cuda]

Stages, each timed after a warm call, the best of 3 passes over the batch,
printed as ms per frame beside the card's name and power limit (CUDA
events on the card, time.perf_counter on the CPU): pyr (the pyramid),
score (+ K1 on every level), sel1 (the pyramid, K1 on level 0 and its
select), all (K1 on every level and every level's select).
"""

from __future__ import annotations

import sys

from ..run_mono import parse_args
from ._timing import best_ms, card_label

STAGES = ("pyr", "score", "sel1", "all")


def stage_fn(stage, ext):
    """One frame through `stage`: (H, W) image tensor -> a scalar tensor."""
    from ..frontend import cuda_fast, select

    cfg = ext.cfg

    def run(im):
        levels = ext.levels(im)
        if stage == "pyr":
            return sum(l.sum() for l in levels)
        if stage == "sel1":
            score = cuda_fast.fast_nms(levels[0], cfg.detect_th)
            xy, resp, _ = select.select_spread_topk(score, cfg.level_budgets[0], cfg.border)
            return xy.sum() + resp.sum()
        scores = cuda_fast.fast_nms_levels(levels, cfg.detect_th)
        if stage == "score":
            return sum(s.sum() for s in scores)
        acc = 0.0
        for lvl, budget in enumerate(cfg.level_budgets):
            xy, resp, _ = select.select_spread_topk(scores[lvl], budget, cfg.border)
            acc = acc + xy.sum() + resp.sum()
        return acc
    return run


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    import numpy as np
    import torch

    from ..frontend.extractor import ExtractorConfig, FeatureExtractor

    device = torch.device(args.get("device", "cuda"))
    n = int(args.get("n_frames", 64))
    ext = FeatureExtractor(ExtractorConfig(n_features=1000), 480, 640).to(device)
    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.uniform(0, 255, (n, 480, 640)).astype(np.float32)).to(device)
    card = card_label(device)
    with torch.no_grad():
        for st in STAGES:
            fn = stage_fn(st, ext)
            best = best_ms(lambda: [fn(im) for im in batch], device)
            print(st, round(best / n, 3), "ms/frame", f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
