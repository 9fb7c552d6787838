"""Kernel K1: FAST-9/16 score fused with 3x3 NMS, in CUDA
(``csrc/fast_nms.cu``). Port of anyfeature_vslam_tpu/frontend/pallas_fast.py.

``fast_nms`` launches the kernel for a CUDA tensor and uses the plain twin
``fast.nms3x3(fast.fast_score_map(...))`` for a CPU tensor; it never falls
back from one to the other. ``fast_nms.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build
from . import fast

_P = ctypes.c_void_p


@functools.cache
def _lib():
    lib = cuda_build.load("fast_nms")
    lib.fast_nms_f32.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P]
    lib.fast_nms_f32.restype = ctypes.c_int
    return lib


def fast_nms_plain(img, threshold: float):
    """The plain PyTorch twin of the kernel."""
    return fast.nms3x3(fast.fast_score_map(img, threshold))


def fast_nms(img, threshold: float):
    """FAST score + 3x3 NMS of one pyramid level. img: (H, W) float32 in
    0..255 -> (H, W) float32 scores, zero off the suppressed corners."""
    if img.device.type == "cpu":
        return fast_nms_plain(img, threshold)
    if img.device.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(
            f"fast_nms: need a contiguous 2-D float32 image, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}"
        )
    h, w = img.shape
    out = torch.empty_like(img)
    lib = _lib()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.fast_nms_f32(img.data_ptr(), out.data_ptr(), h, w,
                               float(threshold), stream)
    if err != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: CUDA error {err}")
    fast_nms.launches += 1
    return out


fast_nms.launches = 0
