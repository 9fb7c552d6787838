"""K2's search worked out again, in plain PyTorch, and the judge of its
answers.

The search, as the configuration states it: for each query, among the
candidates with |du|, |dv| <= the query's radius (a negative radius
disables the row), the query's size band around the candidate's size and
the candidate valid, the smallest distance, its index (the lowest on
ties) and the smallest distance over the other candidates. Binary
descriptors ({0,1} bits, or candidates packed little-endian into int32
words) are compared by Hamming distance, float32 ones by squared L2.

The reference works the distances out in float64, where both are exact to
far below a float32 rounding. ``precision="tf32"`` gives the control: the
float operands rounded to TF32's 10-bit mantissa, products summed in
float32 (what TF32 tensor cores do); binary distances are integers and
have no lower precision, so there the control equals the reference.
"""

from __future__ import annotations

import math

import torch

NONE = 1.0e8  # a returned distance at or above this means "no candidate"


def unpack_words(words, d: int):
    """(N, ceil(d / 32)) int32 little-endian words -> (N, d) uint8 bits."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :d].to(torch.uint8)


def tf32(x):
    """float32 rounded to nearest on TF32's 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def distances(q, c, precision: str = "float64"):
    """(Nq, Nc) distances of the queries to the candidates (bits or rows)."""
    if q.dtype == torch.uint8:
        a, b = q.to(torch.float64), c.to(torch.float64)
        return a.sum(1)[:, None] + b.sum(1)[None, :] - 2.0 * (a @ b.T)
    if precision == "tf32":
        a, b = tf32(q.to(torch.float32)), tf32(c.to(torch.float32))
        dot = (a @ b.T).to(torch.float64)
        na = (a * a).sum(1).to(torch.float64)
        nb = (b * b).sum(1).to(torch.float64)
        return na[:, None] + nb[None, :] - 2.0 * dot
    a, b = q.to(torch.float64), c.to(torch.float64)
    return (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)


def gates(q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid):
    """(Nq, Nc) bool: the pairs within the window and size band, to a valid
    candidate."""
    du = torch.abs(q_uv[:, None, 0] - c_uv[None, :, 0])
    dv = torch.abs(q_uv[:, None, 1] - c_uv[None, :, 1])
    ok = (du <= q_rad[:, None]) & (dv <= q_rad[:, None])
    ok &= (c_size[None, :] >= q_slo[:, None]) & (c_size[None, :] <= q_shi[:, None])
    return ok & c_valid[None, :]


def best_two(dist, ok):
    """(best, index or -1, second) over the allowed pairs; inf where none."""
    d = torch.where(ok, dist, torch.full_like(dist, math.inf))
    best, idx = torch.min(d, dim=1)  # the first minimum: the lowest index
    rows = torch.arange(d.shape[0], device=d.device)
    others = d.clone()
    others[rows, idx] = math.inf
    second = others.min(dim=1).values
    idx = torch.where(torch.isfinite(best), idx, torch.full_like(idx, -1))
    return best, idx, second


def candidates(c_feat, c_dim):
    """The candidates' bits or rows, from what the search was handed: bits,
    rows, packed words with their width, or rows with their norms (the
    norms are the program's and are not used)."""
    if isinstance(c_feat, (tuple, list)):
        return c_feat[0]
    if c_dim is not None:
        return unpack_words(c_feat, int(c_dim))
    return c_feat


def search(call: dict, precision: str = "float64"):
    """The reference's (best, index, second) for one recorded call."""
    q = call["q_feat"]
    dist = distances(q, candidates(call["c_feat"], call.get("c_dim")), precision)
    ok = gates(call["q_uv"], call["c_uv"], call["q_rad"], call["q_slo"], call["q_shi"],
               call["c_size"], call["c_valid"])
    return best_two(dist, ok)


def gap(call: dict, best, idx, second) -> tuple[float, int]:
    """(widest gap, queries judged) of the answers (best, idx, second) to
    one recorded call, against the reference in float64. Per query: the
    chosen candidate's distance above the best one's, and the returned
    best's and second's distances off the reference's (the second over
    the candidates other than the one chosen), in units of the query's
    distance scale: 1 bit for binary descriptors, |q|^2 + the largest
    |c|^2 for float ones. A candidate chosen outside the gates, none
    chosen where one passes them, or one chosen where none does: inf."""
    q = call["q_feat"]
    c = candidates(call["c_feat"], call.get("c_dim"))
    dist = distances(q, c)
    ok = gates(call["q_uv"], call["c_uv"], call["q_rad"], call["q_slo"], call["q_shi"],
               call["c_size"], call["c_valid"])
    nq = q.shape[0]
    if nq == 0:
        return 0.0, 0
    ref_best, _, _ = best_two(dist, ok)
    if q.dtype == torch.uint8:
        scale = torch.ones(nq, dtype=torch.float64, device=q.device)
    else:
        qn = (q.to(torch.float64) ** 2).sum(1)
        cn = (c.to(torch.float64) ** 2).sum(1)
        scale = qn + (cn.max() if cn.numel() else 0.0)
    best, second = best.to(torch.float64), second.to(torch.float64)
    idx = idx.to(torch.int64)
    has = ok.any(1)
    chosen = idx >= 0
    g = torch.zeros(nq, dtype=torch.float64, device=q.device)
    g = torch.where(has != chosen, torch.full_like(g, math.inf), g)
    rows = torch.nonzero(has & chosen)[:, 0]
    if rows.numel():
        j = idx[rows]
        inside = ok[rows, j]
        d_j = dist[rows, j]
        others = torch.where(ok[rows], dist[rows], torch.full_like(dist[rows], math.inf))
        others[torch.arange(rows.numel(), device=q.device), j] = math.inf
        ref_second = others.min(dim=1).values
        # no other candidate: the search returns its "none" distance
        sec_gap = torch.where(torch.isfinite(ref_second), torch.abs(second[rows] - ref_second),
                              torch.where(second[rows] >= NONE, torch.zeros_like(d_j),
                                          torch.full_like(d_j, math.inf)))
        e = torch.maximum(torch.maximum(d_j - ref_best[rows], torch.abs(best[rows] - d_j)),
                          sec_gap) / scale[rows]
        g[rows] = torch.where(inside, e, torch.full_like(e, math.inf))
    return float(g.max()), int(nq)
