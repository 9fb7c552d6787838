"""Kernel K2: masked best / argmin / second-best descriptor search, in CUDA
(``csrc/best_two.cu``). Port of anyfeature_vslam_tpu/ops/pallas_match.py.

``best_two`` launches the kernel for CUDA tensors and uses the plain twin
``reference_best_two`` for CPU tensors; it never falls back from one to the
other, and unlike the JAX dispatcher it has no size threshold: every
guided search on the card goes through the kernel. ``best_two.launches``
counts kernel launches.

Semantics (both versions): for each query, among candidates with
|du|, |dv| <= q_rad (a negative radius disables the row), q_slo <= c_size
<= q_shi and c_valid, the smallest distance, its index (lowest on ties)
and the smallest distance over the other candidates. Binary descriptors
({0,1} uint8) use Hamming, float32 descriptors squared L2. No candidate:
best = second = INF and index -1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build

INF = 3.0e8
_P = ctypes.c_void_p
_I = ctypes.c_int
_BIT_WIDTHS = (256, 384, 488, 512)
_FLOAT_WIDTHS = (48, 64, 128)


@functools.cache
def _lib():
    lib = cuda_build.load("best_two")
    lib.best_two_bits.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P] + [_P] * 11
    lib.best_two_bits.restype = _I
    lib.best_two_f32.argtypes = [_P, _P, _I, _I, _I] + [_P] * 11
    lib.best_two_f32.restype = _I
    return lib


def reference_best_two(q_feat, c_feat, q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid):
    """Plain PyTorch twin of the kernel: the dense (Nq, Nc) distance
    matrix, the gates as a mask, then matching.best_two."""
    from . import matching

    dist = matching.descriptor_distance_matrix(q_feat, c_feat)
    du = torch.abs(q_uv[:, None, 0] - c_uv[None, :, 0])
    dv = torch.abs(q_uv[:, None, 1] - c_uv[None, :, 1])
    ok = (du <= q_rad[:, None]) & (dv <= q_rad[:, None])
    ok &= (c_size[None, :] >= q_slo[:, None]) & (c_size[None, :] <= q_shi[:, None])
    ok &= c_valid[None, :]
    best, idx, second = matching.best_two(dist, ok)
    idx = torch.where(best < INF, idx, torch.full_like(idx, -1))
    return best, idx, second


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"best_two: {name} must be contiguous {dtype} {shape}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def best_two(q_feat, c_feat, q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid):
    """Masked best/second-best search. q_feat (Nq, D), c_feat (Nc, D):
    uint8 {0,1} with D in {256, 384, 488, 512} or float32 with D in
    {48, 64, 128}; q_uv (Nq, 2), q_rad/q_slo/q_shi (Nq,), c_uv (Nc, 2),
    c_size (Nc,) float32; c_valid (Nc,) bool. Returns (best, idx, second):
    (Nq,) float32, int32, float32."""
    dev = q_feat.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"best_two: unsupported device {dev}")
    args = (q_feat, c_feat, q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid)
    if any(t.device != dev for t in args):
        raise ValueError(f"best_two: inputs on {sorted({str(t.device) for t in args})}")
    if dev.type == "cpu":
        best, idx, second = reference_best_two(*args)
        return best, idx.to(torch.int32), second
    nq, d = q_feat.shape
    nc = c_feat.shape[0]
    binary = q_feat.dtype == torch.uint8
    if binary and d not in _BIT_WIDTHS or not binary and (
            q_feat.dtype != torch.float32 or d not in _FLOAT_WIDTHS):
        raise ValueError(f"best_two: unsupported descriptors {q_feat.dtype} x {d}")
    f32 = torch.float32
    _check("q_feat", q_feat, q_feat.dtype, (nq, d))
    _check("c_feat", c_feat, q_feat.dtype, (nc, d))
    _check("q_uv", q_uv, f32, (nq, 2))
    for name, t in (("q_rad", q_rad), ("q_slo", q_slo), ("q_shi", q_shi)):
        _check(name, t, f32, (nq,))
    _check("c_uv", c_uv, f32, (nc, 2))
    _check("c_size", c_size, f32, (nc,))
    _check("c_valid", c_valid, torch.bool, (nc,))

    best = torch.empty(nq, dtype=f32, device=dev)
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    second = torch.empty(nq, dtype=f32, device=dev)
    if nq == 0:
        return best, idx, second
    if nc == 0:
        return best.fill_(INF), idx.fill_(-1), second.fill_(INF)
    side = [t.data_ptr() for t in (q_uv, q_rad, q_slo, q_shi, c_uv, c_size, c_valid,
                                   best, idx, second)]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if binary:
            nwords = (d + 31) // 32  # 8, 12 or 16
            q_words = torch.empty((nq, nwords), dtype=torch.int32, device=dev)
            c_words = torch.empty((nc, nwords), dtype=torch.int32, device=dev)
            err = lib.best_two_bits(q_feat.data_ptr(), c_feat.data_ptr(), nq, nc, d,
                                    nwords, q_words.data_ptr(), c_words.data_ptr(),
                                    *side, stream)
        else:
            err = lib.best_two_f32(q_feat.data_ptr(), c_feat.data_ptr(), nq, nc, d,
                                   *side, stream)
    if err != 0:
        raise RuntimeError(f"best_two kernel launch failed: CUDA error {err}")
    best_two.launches += 1
    return best, idx, second


best_two.launches = 0
