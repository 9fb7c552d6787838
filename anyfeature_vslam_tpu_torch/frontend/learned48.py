"""Learned 48-d float descriptor, the anyfeat_nonbin descriptor (port of
anyfeature_vslam_tpu/frontend/learned48.py).

A 20x20 patch is sampled on the keypoint's rotated grid (graddesc's
constant bilinear matrix, one product over all 16 rotation steps and a
pick of the keypoint's step), mean/std normalised, and mapped by a small
MLP (400 -> 256 -> relu -> 128 -> relu -> 48) to a unit-L2 descriptor.
The trained weights ship with the port as ``weights/learned48.npz`` beside
this module (a copy of the JAX package's file, in its format: w1..w3 as
(in, out)); ``load_weights`` reads it and ``convert.learned48_from_numpy``
carries it into ``Learned48``. ``tools/train_patch_descriptor.py`` trains
new weights from ``init_params`` and writes that file. A missing file
raises: the JAX package's grad48 fallback is not ported.

Precision as in the JAX package: the sampling product on operands rounded
to bf16, multiplied in fp32 (see ringdesc.py); the MLP in fp32.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from . import graddesc
from .orientation import gather_patches
from .ringdesc import bf16_round, rotation_step

WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights",
                            "learned48.npz")


def load_weights(path: str = WEIGHTS_PATH) -> dict:
    """The MLP's parameters as numpy arrays: w1 (400, 256), b1, w2 (256,
    128), b2, w3 (128, 48), b3 (the JAX layout, x @ w + b)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"learned48 weights not found: {path}")
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def sample_canonical_patches(img, xy, angle, sample_mat):
    """(N, 400) rotation-canonicalised 20x20 patches, mean/std normalised
    (population std, as jnp.std), from the raw level image."""
    n = xy.shape[0]
    patch = gather_patches(img, xy, graddesc.PATCH_RADIUS).reshape(n, -1)
    samp = (bf16_round(patch) @ sample_mat).view(n, graddesc.N_ROT, graddesc._N_SAMP)
    step = rotation_step(angle, graddesc.N_ROT)
    samp = torch.gather(samp, 1, step[:, None, None].expand(n, 1, graddesc._N_SAMP))[:, 0]
    mu = samp.mean(dim=-1, keepdim=True)
    sd = samp.std(dim=-1, keepdim=True, correction=0)
    return (samp - mu) / torch.clamp(sd, min=1e-3)


class Learned48(nn.Module):
    """400 -> 256 -> relu -> 128 -> relu -> 48, unit-L2 output."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(400, 256)
        self.fc2 = nn.Linear(256, 128)
        self.fc3 = nn.Linear(128, 48)

    def forward(self, x):
        h = torch.relu(self.fc1(x))
        h = torch.relu(self.fc2(h))
        d = self.fc3(h)
        return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-8)


def describe_learned48(img, xy, angle, valid, sample_mat, mlp):
    """(N, 48) float32 descriptors from the raw level image, zero on
    invalid rows. sample_mat: ``graddesc.sample_tensor()`` on the image's device;
    mlp: a ``Learned48`` on the same device."""
    d = mlp(sample_canonical_patches(img, xy, angle, sample_mat))
    return torch.where(valid[:, None], d, torch.zeros_like(d))


def init_params(seed: int = 0) -> dict:
    """He-initialised MLP parameters as numpy arrays in the weights file's
    layout (w (in, out), b zero), drawn from ``np.random.default_rng(seed)``
    in the JAX package's order (the training tool's starting point)."""
    rng = np.random.default_rng(seed)

    def lin(n_in, n_out):
        w = rng.normal(0, np.sqrt(2.0 / n_in), (n_in, n_out)).astype(np.float32)
        return w, np.zeros(n_out, np.float32)

    w1, b1 = lin(400, 256)
    w2, b2 = lin(256, 128)
    w3, b3 = lin(128, 48)
    return dict(w1=w1, b1=b1, w2=w2, b2=b2, w3=w3, b3=b3)
