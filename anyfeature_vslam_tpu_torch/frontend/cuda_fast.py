"""Kernel K1: FAST-9/16 score fused with 3x3 NMS, in CUDA
(``csrc/fast_nms.cu``). Port of anyfeature_vslam_tpu/frontend/pallas_fast.py.

``fast_nms_levels`` scores all pyramid levels of a frame in one launch;
``fast_nms`` is the same kernel on one level. Both launch the kernel for
CUDA tensors and use the plain twin ``fast.nms3x3(fast.fast_score_map(...))``
for CPU tensors; they never fall back from one to the other.
``fast_nms.launches`` counts launches of the kernel, by either function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from . import fast

MAX_LEVELS = 8  # levels one launch takes (csrc/fast_nms.cu kMaxLevels)
_P = ctypes.c_void_p


@functools.cache
def _lib():
    lib = cuda_build.load("fast_nms")
    ptrs, ints = ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_int)
    lib.fast_nms_levels_f32.argtypes = [ptrs, ptrs, ints, ints, ctypes.c_int, ctypes.c_float, _P]
    lib.fast_nms_levels_f32.restype = ctypes.c_int
    return lib


def fast_nms_plain(img, threshold: float):
    """The plain PyTorch twin of the kernel."""
    return fast.nms3x3(fast.fast_score_map(img, threshold))


def fast_nms_levels(levels, threshold: float):
    """FAST score + 3x3 NMS of up to 8 pyramid levels. levels: (H_l, W_l)
    float32 images in 0..255, all on one device -> a list of (H_l, W_l)
    float32 score maps, zero off the suppressed corners. On the card: one
    launch; the maps are views of one buffer."""
    levels = list(levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_nms_levels: takes 1..{MAX_LEVELS} levels, got {len(levels)}")
    dev = levels[0].device
    if any(l.device != dev for l in levels):
        raise ValueError(f"fast_nms_levels: levels on {sorted({str(l.device) for l in levels})}")
    if dev.type == "cpu":
        return [fast_nms_plain(l, threshold) for l in levels]
    if dev.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {dev}")
    for l in levels:
        if l.dtype != torch.float32 or l.dim() != 2 or not l.is_contiguous():
            raise ValueError(
                f"fast_nms: need contiguous 2-D float32 images, got "
                f"{l.dtype} {tuple(l.shape)} contiguous={l.is_contiguous()}"
            )
    sizes = [l.numel() for l in levels]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    outs = [o.view(l.shape) for o, l in zip(flat.split(sizes), levels)]
    n = len(levels)
    ptrs_in = (_P * n)(*[l.data_ptr() for l in levels])
    ptrs_out = (_P * n)(*[o.data_ptr() for o in outs])
    hs = (ctypes.c_int * n)(*[l.shape[0] for l in levels])
    ws = (ctypes.c_int * n)(*[l.shape[1] for l in levels])
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fast_nms_levels_f32(ptrs_in, ptrs_out, hs, ws, n, float(threshold), stream)
    if err != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: CUDA error {err}")
    fast_nms.launches += 1
    return outs


def fast_nms(img, threshold: float):
    """FAST score + 3x3 NMS of one pyramid level. img: (H, W) float32 in
    0..255 -> (H, W) float32 scores, zero off the suppressed corners."""
    return fast_nms_levels([img], threshold)[0]


fast_nms.launches = 0
