"""Spatially spread top-K keypoint selection (port of
anyfeature_vslam_tpu/frontend/select.py).

The level is cut into ~budget grid cells; each cell keeps its best
``K_CELL`` candidates; the ``budget`` winners are ordered by (rank within
cell, -score), so every cell's winner comes before any runner-up. Ties
follow the JAX package exactly: ``argmax`` takes the first maximum and the
final ranking is a stable sort, lower index first among equal keys (as
``lax.top_k``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

K_CELL = 4  # candidates retained per cell before global ranking


def grid_dims(h: int, w: int, budget: int):
    """Pick a cell grid with roughly `budget` cells matching the aspect."""
    gy = max(int(round(math.sqrt(budget * h / max(w, 1)))), 1)
    gx = max((budget + gy - 1) // gy, 1)
    return gy, gx


def select_spread_topk(score, budget: int, border: int = 16):
    """Select up to `budget` spread keypoints from an NMS'd (H, W) score map.

    Returns xy (budget, 2) float32 (x, y) level coordinates, resp
    (budget,) float32 and valid (budget,) bool.
    """
    h, w = score.shape
    dev = score.device
    ok = torch.zeros((h, w), dtype=torch.bool, device=dev)
    ok[border:h - border, border:w - border] = True
    score = torch.where(ok, score, torch.zeros_like(score))

    gy, gx = grid_dims(h, w, budget)
    ch = -(-h // gy)
    cw = -(-w // gx)
    padded = F.pad(score, (0, gx * cw - w, 0, gy * ch - h))
    cells = padded.reshape(gy, ch, gx, cw).permute(0, 2, 1, 3).reshape(gy * gx, ch * cw)

    k = min(K_CELL, ch * cw)
    col = torch.arange(ch * cw, device=dev)[None, :]
    cur = cells
    scores_l, args_l = [], []
    for _ in range(k):
        am = torch.argmax(cur, dim=1)
        scores_l.append(torch.gather(cur, 1, am[:, None])[:, 0])
        args_l.append(am)
        cur = torch.where(col == am[:, None], -math.inf, cur)
    cell_scores = torch.stack(scores_l, 1)  # (G, k)
    cell_arg = torch.stack(args_l, 1)
    cell_id = torch.arange(gy * gx, device=dev)[:, None]
    abs_y = (cell_id // gx) * ch + cell_arg // cw
    abs_x = (cell_id % gx) * cw + cell_arg % cw

    flat_scores = cell_scores.reshape(-1)
    flat_rank = torch.arange(k, device=dev).repeat(gy * gx).to(torch.float32)
    pos = flat_scores > 0.0
    key = torch.where(pos, -flat_rank * 1e6 + torch.clamp(flat_scores, max=1e5),
                      torch.full_like(flat_scores, -math.inf))
    take = min(budget, key.shape[0])
    top_key, top_idx = torch.sort(key, descending=True, stable=True)
    top_key, top_idx = top_key[:take], top_idx[:take]
    sel_y = abs_y.reshape(-1)[top_idx]
    sel_x = abs_x.reshape(-1)[top_idx]
    sel_s = flat_scores[top_idx]
    sel_valid = top_key > -math.inf

    pad = budget - take
    if pad > 0:
        sel_y = F.pad(sel_y, (0, pad))
        sel_x = F.pad(sel_x, (0, pad))
        sel_s = F.pad(sel_s, (0, pad))
        sel_valid = F.pad(sel_valid, (0, pad))
    xy = torch.stack([sel_x.to(torch.float32), sel_y.to(torch.float32)], -1)
    return xy, sel_s, sel_valid
