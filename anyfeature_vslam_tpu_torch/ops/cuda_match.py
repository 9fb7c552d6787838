"""Kernel K2: masked best / argmin / second-best descriptor search, in CUDA
(``csrc/best_two.cu``). Port of anyfeature_vslam_tpu/ops/pallas_match.py.

``best_two`` launches the kernel for CUDA tensors and uses the plain twin
``reference_best_two`` for CPU tensors; it never falls back from one to the
other, and unlike the JAX dispatcher it has no size threshold: every
guided search on the card goes through the kernel. Candidates shared by
several searches are prepared once (``pack_candidates``): binary ones
packed into words (``pack_bits``), float ones as a ``FloatSet`` (the
contiguous rows and their norms). A search is then one launch, since each
warp packs its own binary query or takes its float query's norm; a search
given raw candidates prepares them itself. ``best_two.launches`` counts
search launches (and ``thread_launches()`` those made by the calling
thread), ``pack_bits.launches`` pack launches.

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
import threading
from typing import NamedTuple

import torch

from .. import cuda_build

INF = 3.0e8
_P = ctypes.c_void_p
_I = ctypes.c_int
_BIT_WIDTHS = (256, 384, 488, 512)
_FLOAT_WIDTHS = (48, 64, 128)


@functools.cache
def _lib(device_index: int):
    """The kernels, loaded, with the binary kernels' shared-memory limit
    raised on this device (best_two_init)."""
    lib = cuda_build.load("best_two")
    lib.best_two_init.argtypes = []
    lib.best_two_init.restype = _I
    lib.pack_bits.argtypes = [_P, _P, _I, _I, _I, _P]
    lib.pack_bits.restype = _I
    lib.best_two_bits.argtypes = [_P, _P, _I, _I, _I, _I] + [_P] * 11
    lib.best_two_bits.restype = _I
    lib.best_two_f32.argtypes = [_P, _P, _P, _I, _I, _I] + [_P] * 11
    lib.best_two_f32.restype = _I
    with torch.cuda.device(device_index):
        err = lib.best_two_init()
    if err != 0:
        raise RuntimeError(f"best_two_init failed on cuda:{device_index}: CUDA error {err}")
    return lib


def _nwords(d: int) -> int:
    return (d + 31) // 32


def pack_bits_plain(bits):
    """(N, D) {0,1} uint8 -> (N, ceil(D/32)) int32 words: bit k of word w
    is bits[:, 32 w + k] (little-endian), the tail past D is zero."""
    n, d = bits.shape
    nwords = _nwords(d)
    padded = torch.zeros((n, nwords * 32), dtype=torch.int64, device=bits.device)
    padded[:, :d] = bits != 0
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    words = (padded.view(n, nwords, 32) * weights).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits_plain(words, d: int):
    """Inverse of ``pack_bits_plain``: (N, ceil(D/32)) int32 -> (N, D) uint8."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :d].to(torch.uint8)


def pack_bits(bits):
    """Binary descriptors (N, D) {0,1} uint8 -> (N, ceil(D/32)) int32
    packed words (``pack_bits_plain``'s layout), the candidate form
    ``best_two`` takes with ``c_dim=D``. On the card: one launch."""
    dev = bits.device
    if dev.type == "cpu":
        return pack_bits_plain(bits)
    if dev.type != "cuda":
        raise ValueError(f"pack_bits: unsupported device {dev}")
    if bits.dtype != torch.uint8 or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError(f"pack_bits: need contiguous 2-D uint8 bits, got {bits.dtype} "
                         f"{tuple(bits.shape)} contiguous={bits.is_contiguous()}")
    n, d = bits.shape
    words = torch.empty((n, _nwords(d)), dtype=torch.int32, device=dev)
    if n == 0:
        return words
    lib = _lib(dev.index)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pack_bits(bits.data_ptr(), words.data_ptr(), n, d, words.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"pack_bits kernel launch failed: CUDA error {err}")
    pack_bits.launches += 1
    return words


pack_bits.launches = 0


class FloatSet(NamedTuple):
    """Float candidates prepared once for the searches that share them:
    the contiguous (N, D) float32 rows and their squared norms (N,)."""

    rows: torch.Tensor
    norms: torch.Tensor


def prepare_float(desc) -> FloatSet:
    """(N, D) float32 rows -> FloatSet. The norms are the twin's own
    expression (matching.l2sq_matrix), so they equal its norms bit for
    bit on the same device; the JAX wrapper also takes them outside its
    kernel."""
    rows = desc.contiguous()
    return FloatSet(rows, torch.sum(rows * rows, dim=-1))


def pack_candidates(desc):
    """Candidates shared by several searches, in the form they take them:
    binary descriptors packed once (``pack_bits``), float ones prepared
    once (``prepare_float``)."""
    return pack_bits(desc.contiguous()) if desc.dtype == torch.uint8 else prepare_float(desc)


def gate_mask(q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid):
    """(Nq, Nc) bool: the pairs that pass the window, size and validity
    gates."""
    du = torch.abs(q_uv[:, None, 0] - c_uv[None, :, 0])
    dv = torch.abs(q_uv[:, None, 1] - c_uv[None, :, 1])
    ok = (du <= q_rad[:, None]) & (dv <= q_rad[:, None])
    ok &= (c_size[None, :] >= q_slo[:, None]) & (c_size[None, :] <= q_shi[:, None])
    return ok & c_valid[None, :]


def reference_best_two(q_feat, c_feat, q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid,
                       c_dim=None):
    """Plain PyTorch twin of the kernel: the dense (Nq, Nc) distance
    matrix, the gates as a mask, then matching.best_two. With ``c_dim``,
    c_feat holds packed words (``pack_bits``) of c_dim-bit descriptors; a
    FloatSet gives its rows and norms."""
    from . import matching

    if isinstance(c_feat, FloatSet):
        dist = matching.l2sq_matrix(q_feat, c_feat.rows, nb=c_feat.norms)
    else:
        if c_dim is not None:
            c_feat = unpack_bits_plain(c_feat, c_dim)
        dist = matching.descriptor_distance_matrix(q_feat, c_feat)
    ok = gate_mask(q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid)
    best, idx, second = matching.best_two(dist, ok)
    idx = torch.where(best < INF, idx, torch.full_like(idx, -1))
    return best, idx, second


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"best_two: {name} must be contiguous {dtype} {shape}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _check_float_set(q_feat, c):
    """A FloatSet fits the float32 queries: same width, one norm per row."""
    rows, norms = c
    if (q_feat.dtype != torch.float32 or q_feat.dim() != 2 or rows.dtype != torch.float32
            or rows.dim() != 2 or rows.shape[1] != q_feat.shape[1]
            or norms.dtype != torch.float32 or tuple(norms.shape) != (rows.shape[0],)):
        raise ValueError(f"best_two: prepared float candidates {rows.dtype} {tuple(rows.shape)} "
                         f"with norms {norms.dtype} {tuple(norms.shape)} for {q_feat.dtype} "
                         f"{tuple(q_feat.shape)} queries")


def _aligned(name, t, nbytes):
    if t.data_ptr() % nbytes:
        raise ValueError(f"best_two: {name} must be {nbytes}-byte aligned")


def best_two(q_feat, c_feat, q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid, c_dim=None):
    """Masked best/second-best search. q_feat (Nq, D), c_feat (Nc, D):
    uint8 {0,1} with D in {256, 384, 488, 512} or float32 with D in
    {48, 64, 128}; or c_feat prepared once by ``pack_candidates``:
    binary, (Nc, ceil(D/32)) int32 packed words with c_dim = D; float, a
    ``FloatSet``. q_uv (Nq, 2), q_rad/q_slo/q_shi (Nq,), c_uv (Nc, 2),
    c_size (Nc,) float32; c_valid (Nc,) bool. Returns (best, idx,
    second): (Nq,) float32, int32, float32."""
    dev = q_feat.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"best_two: unsupported device {dev}")
    prepared = isinstance(c_feat, FloatSet)
    c_tensors = tuple(c_feat) if prepared else (c_feat,)
    args = (q_feat, *c_tensors, q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid)
    if any(t.device != dev for t in args):
        raise ValueError(f"best_two: inputs on {sorted({str(t.device) for t in args})}")
    if prepared:
        _check_float_set(q_feat, c_feat)
    if c_dim is not None and (q_feat.dtype != torch.uint8 or q_feat.shape[1] != c_dim
                              or c_feat.dtype != torch.int32 or c_feat.dim() != 2
                              or c_feat.shape[1] != _nwords(c_dim)):
        raise ValueError(f"best_two: packed candidates {c_feat.dtype} {tuple(c_feat.shape)} of "
                         f"{c_dim} bits for {q_feat.dtype} {tuple(q_feat.shape)} queries")
    if dev.type == "cpu":
        best, idx, second = reference_best_two(q_feat, c_feat, q_uv, c_uv, q_rad, q_slo, q_shi,
                                               c_size, c_valid, c_dim=c_dim)
        return best, idx.to(torch.int32), second
    nq, d = q_feat.shape
    nc = c_tensors[0].shape[0]
    binary = q_feat.dtype == torch.uint8
    if binary and d not in _BIT_WIDTHS or not binary and (
            q_feat.dtype != torch.float32 or d not in _FLOAT_WIDTHS):
        raise ValueError(f"best_two: unsupported descriptors {q_feat.dtype} x {d}")
    f32 = torch.float32
    _check("q_feat", q_feat, q_feat.dtype, (nq, d))
    if c_dim is not None:
        _check("c_feat", c_feat, torch.int32, (nc, _nwords(d)))
        _aligned("packed candidate words", c_feat, 16)
    elif binary:
        _check("c_feat", c_feat, torch.uint8, (nc, d))
    else:
        if not prepared:
            _check("c_feat", c_feat, f32, (nc, d))
            c_feat = prepare_float(c_feat)
        _check("candidate rows", c_feat.rows, f32, (nc, d))
        _check("candidate norms", c_feat.norms, f32, (nc,))
        for name, t in (("q_feat", q_feat), ("candidate rows", c_feat.rows)):
            _aligned(name, t, 16)
        _aligned("c_uv", c_uv, 8)
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
    if binary and c_dim is None:
        c_feat = pack_bits(c_feat)
    side = [t.data_ptr() for t in (q_uv, q_rad, q_slo, q_shi, c_uv, c_size, c_valid,
                                   best, idx, second)]
    lib = _lib(dev.index)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if binary:
            err = lib.best_two_bits(q_feat.data_ptr(), c_feat.data_ptr(), nq, nc, d,
                                    _nwords(d), *side, stream)
        else:
            err = lib.best_two_f32(q_feat.data_ptr(), c_feat.rows.data_ptr(),
                                   c_feat.norms.data_ptr(), nq, nc, d, *side, stream)
    if err != 0:
        raise RuntimeError(f"best_two kernel launch failed: CUDA error {err}")
    best_two.launches += 1
    _local.best_two = thread_launches() + 1
    return best, idx, second


best_two.launches = 0
_local = threading.local()


def thread_launches() -> int:
    """Launches of ``best_two``'s kernel made by the calling thread."""
    return getattr(_local, "best_two", 0)
