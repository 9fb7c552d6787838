"""Numpy state of the JAX side -> the port's tensors on an explicit device.

The one family with learned weights is anyfeat_nonbin: ``learned48_from_numpy``
carries the MLP parameters of a weights file (the JAX package's format) into
the port's ``Learned48``, and ``learned48_to_numpy`` takes them back out.
The other families' constants live in ``FeatureExtractor``. What else
crosses over is the camera and the fused step's device state, laid out as
``Tracker._build_fast_carry`` / ``_build_fast_state`` build it in the JAX
package (anyfeature_vslam_tpu/slam/tracking.py). A whole map crosses as a
checkpoint file: the port's ``slam.map_state.SlamMap.load`` reads what the
JAX package's ``SlamMap.save`` writes (the same format, both ways), and
``System.load_checkpoint`` loads one into a running System. A DBoW2
vocabulary crosses as its text file (either package's ``save_dbow2_text``
output loads in the other) or, parsed, through ``dbow2_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from .frontend.learned48 import Learned48
from .ops.camera import CameraParams

CARRY_KEYS = ("uv", "bits", "size", "angle", "match_pt", "match_pos")
REF_KEYS = ("ref_bits", "ref_angle", "ref_has", "ref_match_pt", "ref_match_pos")
BLOCK_KEYS = ("blk_ids", "blk_pos", "blk_normal", "blk_min_dist", "blk_max_dist",
              "blk_ref_size", "blk_ref_dist", "blk_bits", "blk_valid")

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float32,
           np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool,
           np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int32}


def camera_from_numpy(cam, device) -> CameraParams:
    """Any object with fx, fy, cx, cy, k1, k2, p1, p2, k3 (numbers or 0-d
    arrays, e.g. the JAX CameraParams) and width, height."""
    return CameraParams.create(
        *(np.float32(getattr(cam, k)) for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")),
        width=int(cam.width), height=int(cam.height), device=device,
    )


def learned48_from_numpy(params: dict, device) -> Learned48:
    """The learned48 MLP from the dict of numpy arrays that JAX
    ``learned48.load_weights()`` returns (w1..w3 as (in, out), b1..b3):
    ``nn.Linear`` keeps (out, in), so each matrix is transposed."""
    mlp = Learned48()
    with torch.no_grad():
        for k, layer in enumerate((mlp.fc1, mlp.fc2, mlp.fc3), start=1):
            w = np.asarray(params[f"w{k}"], np.float32)
            b = np.asarray(params[f"b{k}"], np.float32)
            if layer.weight.shape != w.T.shape or layer.bias.shape != b.shape:
                raise ValueError(f"learned48 layer {k}: {w.shape}, {b.shape} do not fit "
                                 f"{tuple(layer.weight.shape)}")
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
            layer.bias.copy_(torch.from_numpy(b))
    return mlp.requires_grad_(False).to(device)


def learned48_to_numpy(mlp: Learned48) -> dict:
    """The inverse of ``learned48_from_numpy``: w1..w3 as (in, out) and
    b1..b3, float32 numpy arrays in the weights file's format."""
    out = {}
    for k, layer in enumerate((mlp.fc1, mlp.fc2, mlp.fc3), start=1):
        out[f"w{k}"] = np.ascontiguousarray(layer.weight.detach().cpu().numpy().T, np.float32)
        out[f"b{k}"] = np.asarray(layer.bias.detach().cpu().numpy(), np.float32)
    return out


def tensor_from_numpy(a, device):
    """Array -> tensor on device; float64 -> float32, int64 -> int32 (the
    JAX package's default dtypes)."""
    a = np.array(a)  # a writable copy (arrays from JAX are read-only)
    return torch.from_numpy(a).to(device=device, dtype=_DTYPES[a.dtype])


def track_state_from_numpy(carry, ref, block, device):
    """The fused step's state as a dict keyed by ``fused_track_step``'s
    parameter names (last_uv ... blk_valid).

    carry: mapping with CARRY_KEYS (last frame's uv_und, desc_bits, size,
    angle, matched point ids, their positions); ref: mapping with REF_KEYS
    or a 5-tuple in that order; block: mapping with BLOCK_KEYS or a 9-tuple
    in that order.
    """
    if not isinstance(ref, dict):
        ref = dict(zip(REF_KEYS, ref))
    if not isinstance(block, dict):
        block = dict(zip(BLOCK_KEYS, block))
    state = {f"last_{k}": tensor_from_numpy(carry[k], device) for k in CARRY_KEYS}
    state.update({k: tensor_from_numpy(ref[k], device) for k in REF_KEYS})
    state.update({k: tensor_from_numpy(block[k], device) for k in BLOCK_KEYS})
    return state


def dbow2_from_numpy(vocab):
    """A DBoW2 vocabulary from any object with its numpy fields (branching,
    depth, children, node_desc, leaf_word, word_weight, fold; e.g. the JAX
    package's ``dbow2_io.Dbow2Vocabulary``) as the port's
    ``Dbow2Vocabulary``."""
    from .place_recognition.dbow2_io import Dbow2Vocabulary

    return Dbow2Vocabulary(
        branching=int(vocab.branching), depth=int(vocab.depth),
        children=np.asarray(vocab.children, np.int32), node_desc=np.asarray(vocab.node_desc),
        leaf_word=np.asarray(vocab.leaf_word, np.int32),
        word_weight=np.asarray(vocab.word_weight, np.float32), fold=int(vocab.fold))
