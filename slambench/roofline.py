"""The kernels' least times: bytes and operations per launch, and the
card's peaks.

A launch's least time is the largest of its bytes over the memory rate
and, for each unit that does a part of its arithmetic, that part's
operations over the unit's peak, each counted in the peak's own unit; its
roofline share is that over its device time. Each input byte is counted
read once and each output byte written once; where the work depends on
the data (K1's arc tests at the pixels where a corner is possible, K2's
distances at the pairs that pass its gates) the count is what these
inputs need.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit; 132 SMs at 1.98 GHz): HBM3 3.35 TB/s; the CUDA cores'
float32 issue rate, 33.5 T instructions/s (the data sheet's 67 TFLOP/s
counts a fused multiply-add as 2): compares, min / max, subtractions,
selects and the gates' tests run there, one instruction each, and a norm's
multiply-add is one; TF32 tensor cores 495 TFLOP/s, 2 per multiply-add
(a float32 distance can be split over them, as 3xTF32 does); int8 tensor
cores 1,979 TOP/s, 2 per multiply-add (a Hamming distance over D bits is
a +-1 dot product of D elements).
"""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"cuda_core_instr": 33.5e12, "tf32_tensor": 495e12, "int8_tensor": 1979e12}

# the 16 pixels of FAST's Bresenham circle of radius 3 (dy, dx), clockwise
RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def least_s(nbytes: float, ops: dict) -> float:
    """The least time of `nbytes` moved and `ops` ({peak: operations in
    its unit}) done, each unit working alongside the others."""
    return max([nbytes / PEAK_BYTES_PER_S] + [n / PEAK_OPS_PER_S[k] for k, n in ops.items()])


def k1_work(levels, threshold: float):
    """(bytes, CUDA-core instructions) of one K1 launch over these
    pyramid levels: each float32 pixel read once and its score written
    once; 35 instructions per pixel (16 ring differences, 8 cardinal
    tests, the 3x3 suppression), and 162 more (the arc tree's 128 min /
    max, its two 15-step reductions, the threshold tests) at a live pixel,
    where two adjacent cardinal ring points are both brighter or both
    darker than the threshold: only there can the score be non-zero."""
    nbytes = nops = 0
    for lev in levels:
        h, w = lev.shape
        pad = torch.nn.functional.pad(lev[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
        card = [pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - lev
                for dy, dx in (RING[k] for k in (0, 4, 8, 12))]
        live = torch.zeros_like(lev, dtype=torch.bool)
        for k in range(4):
            a, b = card[k], card[(k + 1) % 4]
            live |= ((a > threshold) & (b > threshold)) | ((a < -threshold) & (b < -threshold))
        nbytes += 8 * h * w
        nops += 35 * h * w + 162 * int(live[3:h - 3, 3:w - 3].sum())
    return nbytes, nops


def k1_least_s(args, kw) -> float:
    levels, threshold = args[0], (args[1] if len(args) > 1 else kw["threshold"])
    nbytes, instr = k1_work(list(levels), float(threshold))
    return least_s(nbytes, {"cuda_core_instr": instr})


def _gate_passes(q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid) -> int:
    """Pairs that pass K2's window, size and validity gates."""
    du = torch.abs(q_uv[:, None, 0] - c_uv[None, :, 0])
    dv = torch.abs(q_uv[:, None, 1] - c_uv[None, :, 1])
    ok = (du <= q_rad[:, None]) & (dv <= q_rad[:, None])
    ok &= (c_size[None, :] >= q_slo[:, None]) & (c_size[None, :] <= q_shi[:, None])
    return int((ok & c_valid[None, :]).sum())


def k2_work(args, kw):
    """(bytes, {peak: operations}) of one K2 launch, or None where the call
    launches nothing. Inputs read once: binary, the query bits and the
    candidates' packed words (the launch reads words whether the caller
    packed them or K2 packed them first); float, 4 B per element of both
    and 4 B per prepared candidate norm; 20 B of gate data per query and
    13 per candidate; 12 B written per query. Operations: per pair that
    passes the gates, a D-element dot product, 2 D on the tensor cores
    (int8 for bits, TF32 for floats); on the CUDA cores, 8 gate
    instructions per pair, 4 per passing pair to keep the best and second,
    and D multiply-adds per float query's norm and per raw float
    candidate's."""
    names = ("q_feat", "c_feat", "q_uv", "c_uv", "q_rad", "q_slo", "q_shi", "c_size", "c_valid",
             "c_dim")
    a = dict(zip(names, args), **kw)
    q, c = a["q_feat"], a["c_feat"]
    prepared = isinstance(c, tuple)
    rows = c[0] if prepared else c
    nq, d = q.shape
    nc = rows.shape[0]
    if nq == 0 or nc == 0:
        return None
    passes = _gate_passes(a["q_uv"], a["c_uv"], a["q_rad"], a["q_slo"], a["q_shi"],
                          a["c_size"], a["c_valid"])
    instr = 8 * nq * nc + 4 * passes
    if q.dtype.is_floating_point:
        nbytes = 4 * d * (nq + nc) + 32 * nq + 13 * nc + (4 * nc if prepared else 0)
        instr += d * (nq + (0 if prepared else nc))
        return nbytes, {"tf32_tensor": 2 * d * passes, "cuda_core_instr": instr}
    nwords = (d + 31) // 32
    nbytes = nq * d + 32 * nq + 4 * nwords * nc + 13 * nc
    return nbytes, {"int8_tensor": 2 * d * passes, "cuda_core_instr": instr}


def k2_least_s(args, kw) -> float:
    work = k2_work(args, kw)
    return 0.0 if work is None else least_s(*work)


def pack_least_s(args, kw) -> float:
    """pack_bits: (N, D) bits read, (N, ceil(D / 32)) words written."""
    bits = args[0] if args else kw["bits"]
    n, d = bits.shape
    if n == 0:
        return 0.0
    return least_s(n * d + 4 * n * ((d + 31) // 32), {})


def launched(kind: str, args, kw) -> bool:
    """Whether a recorded call launched its kernel (K2 and pack_bits
    return early on empty inputs)."""
    if kind == "k2":
        q, c = args[0], args[1]
        return q.shape[0] > 0 and (c[0] if isinstance(c, tuple) else c).shape[0] > 0
    if kind == "pack":
        return (args[0] if args else kw["bits"]).shape[0] > 0
    return True


LEAST_S = {"k1": k1_least_s, "k2": k2_least_s, "pack": pack_least_s}
