"""Masked descriptor matching (port of anyfeature_vslam_tpu/ops/matching.py).

Guided searches are masked best/second-best reductions followed by the
acceptance tests of ``finish_match``: distance threshold, ratio test,
one query per candidate, 30-bin rotation consistency. Tie order is the JAX
package's: argmin/argmax take the first occurrence, scatter-min ties go to
the lowest row, and the top rotation bins are ranked by a stable sort
(lower bin first among equal counts, as ``lax.top_k``).
"""

from __future__ import annotations

import math

import torch

from . import cuda_match

INF = cuda_match.INF

HISTO_LENGTH = 30  # reference src/FeatureMatcher.cc:64
RADIUS_SCALE = 1.15  # reference src/FeatureMatcher.cc:65
_INT_MAX = 2**31 - 1


def hamming_matrix(bits_a, bits_b):
    """(N, D) x (M, D) {0,1} uint8 -> (N, M) float32 Hamming distances via
    the popcount identity |a| + |b| - 2 a.b (exact: fp32 sums of at most
    512 ones, TF32 off)."""
    a = bits_a.to(torch.float32)
    b = bits_b.to(torch.float32)
    return a.sum(-1)[:, None] + b.sum(-1)[None, :] - 2.0 * (a @ b.T)


def l2sq_matrix(a, b):
    """(N, D) x (M, D) float32 -> (N, M) squared L2 distances."""
    na = torch.sum(a * a, dim=-1)
    nb = torch.sum(b * b, dim=-1)
    return torch.clamp(na[:, None] + nb[None, :] - 2.0 * (a @ b.T), min=0.0)


def descriptor_distance_matrix(a, b):
    """uint8 bit planes -> Hamming, float -> squared L2."""
    if a.dtype == torch.uint8:
        return hamming_matrix(a, b)
    return l2sq_matrix(a, b)


def best_two(dist, mask):
    """Per-row best, first argmin and second-best over masked candidates;
    best == INF where no candidate."""
    d = torch.where(mask, dist, torch.full_like(dist, INF))
    best_idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    d2 = d.scatter(1, best_idx[:, None], INF)
    return best, best_idx, d2.amin(-1)


def resolve_unique(match_idx, match_dist, match_valid, n_cand: int):
    """One query per candidate: among queries claiming the same candidate
    keep the smallest distance, ties to the lowest row. Returns validity."""
    dev = match_dist.device
    d = torch.where(match_valid, match_dist, torch.full_like(match_dist, INF))
    best_per_cand = torch.full((n_cand,), INF, device=dev).scatter_reduce(
        0, match_idx, d, reduce="amin")
    keep = match_valid & (d <= best_per_cand[match_idx] + 1e-6)
    row_ids = torch.arange(match_idx.shape[0], dtype=torch.int32, device=dev)
    best_row = torch.full((n_cand,), _INT_MAX, dtype=torch.int32, device=dev).scatter_reduce(
        0, match_idx, torch.where(keep, row_ids, torch.full_like(row_ids, _INT_MAX)),
        reduce="amin")
    return keep & (best_row[match_idx] == row_ids)


def rotation_consistency(angle_q, angle_c, match_idx, match_valid, keep_bins: int = 3):
    """30-bin rotation histogram filter (reference FeatureMatcher.cc:
    1579-1668): keep matches whose rotation falls in the top bins."""
    two_pi = 2.0 * math.pi
    rot = angle_q - angle_c[match_idx]
    rot = torch.where(rot < 0, rot + two_pi, rot)
    # jnp.mod: C fmod, then shift a negative remainder into [0, 2pi)
    rot = torch.fmod(rot, two_pi)
    rot = torch.where(rot < 0, rot + two_pi, rot)
    binf = rot * (HISTO_LENGTH / two_pi)
    bins = torch.clamp(torch.round(binf).to(torch.int64) % HISTO_LENGTH, 0, HISTO_LENGTH - 1)
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=rot.device).scatter_add(
        0, bins, match_valid.to(torch.int32))
    top = torch.sort(counts, descending=True, stable=True).indices[:keep_bins]
    in_top = torch.any(bins[:, None] == top[None, :], dim=-1)
    return match_valid & in_top


def finish_match(best, best_idx, second, n_cand: int, match_th, ratio=None,
                 angle_q=None, angle_c=None, unique: bool = True, ratio_mask=None):
    """Acceptance tests on best/second-best results: distance threshold,
    ratio, unique candidate, then the rotation histogram (reference order).
    Returns dict(idx, dist, valid)."""
    valid = (best < match_th) & (best_idx >= 0)
    if ratio is not None:
        ratio_ok = best < ratio * second
        if ratio_mask is not None:
            ratio_ok = ratio_ok | ~ratio_mask
        valid = valid & ratio_ok
    idx = torch.clamp(best_idx, min=0).to(torch.int64)
    if unique:
        valid = resolve_unique(idx, best, valid, n_cand)
    if angle_q is not None:
        valid = rotation_consistency(angle_q, angle_c, idx, valid)
    return dict(idx=idx, dist=best, valid=valid)


def match(dist, mask, match_th, ratio=None, unique: bool = True):
    """Generic matcher on a dense (N, M) distance matrix and candidate
    mask: threshold, optional ratio test, one query per candidate (the
    JAX ``match`` without its rotation filter, which no ported caller
    uses). Returns dict(idx, dist, valid)."""
    return finish_match(*best_two(dist, mask), dist.shape[1], match_th, ratio=ratio,
                        unique=unique)


def guided_best_two(q_feat, c_feat, q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid,
                    c_words=None):
    """Masked best/second-best search: kernel K2 for CUDA tensors (every
    call, no size threshold), its plain twin for CPU tensors. Side inputs
    are brought to the kernel's float32 / bool layout here. c_words:
    optional ``cuda_match.pack_bits(c_feat)``, packed once by a caller whose
    searches share the candidates; the search then takes them in place of
    c_feat."""
    f32 = torch.float32
    c_dim = None
    if c_words is not None:
        c_feat, c_dim = c_words, c_feat.shape[1]
    return cuda_match.best_two(
        q_feat.contiguous(), c_feat.contiguous(),
        q_uv.to(f32).contiguous(), c_uv.to(f32).contiguous(),
        q_rad.to(f32).contiguous(), q_slo.to(f32).contiguous(),
        q_shi.to(f32).contiguous(), c_size.to(f32).contiguous(),
        c_valid.to(torch.bool).contiguous(), c_dim=c_dim,
    )
