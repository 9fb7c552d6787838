"""Precomputed (learned) feature loading, the r2d2_128 path (copy of
anyfeature_vslam_tpu/io/precomputed.py, numpy only; a CPU test holds it
equal to the original).

The reference's r2d2 extractor reads offline-computed binary files per image
(reference src/Feature_r2d2_128.cpp:21-54, path derivation
src/Image.cpp:18-23, reader loadBinFile src/Utils.cpp:214-228):

    <sequence>/r2d2/keypoints/<stem>.bin    float64 rows [x, y, size]
    <sequence>/r2d2/scores/<stem>.bin       float64 rows [score]
    <sequence>/r2d2/descriptors/<stem>.bin  float64 rows [128 dims]

Features are single-level (automaticTuning skipped,
reference FeatureExtractor.cpp:196-199); descriptors are L2SQR-matched.
This loader emits the same fixed-capacity SoA dict as the live extractors,
as numpy arrays on the host; the tracker uploads it to its device once.
"""

from __future__ import annotations

import os

import numpy as np

ORB_MAX_SIZE = 1.2 ** 7


def load_bin(path: str, cols: int) -> np.ndarray:
    """float64 row-major binary matrix (reference Utils.cpp:214-228)."""
    data = np.fromfile(path, dtype=np.float64)
    if cols > 1 and len(data) % cols != 0:
        raise ValueError(f"{path}: {len(data)} values not divisible by {cols}")
    return data.reshape(-1, cols)


def feature_paths(image_path: str, subdir: str = "r2d2"):
    """Derive the keypoints/scores/descriptors paths from an image path
    (reference src/Image.cpp:18-23: sibling '<subdir>/' tree, stem.bin)."""
    seq_dir = os.path.dirname(os.path.dirname(image_path))
    stem = os.path.splitext(os.path.basename(image_path))[0]
    base = os.path.join(seq_dir, subdir)
    return (
        os.path.join(base, "keypoints", stem + ".bin"),
        os.path.join(base, "scores", stem + ".bin"),
        os.path.join(base, "descriptors", stem + ".bin"),
    )


def load_precomputed_features(
    image_path: str, capacity: int, desc_dim: int = 128, subdir: str = "r2d2"
):
    """Load one frame's precomputed features into the SoA layout.

    Keeps the `capacity` highest-scoring keypoints; single octave; keypoint
    size normalized into ORB's [1, 1.2^7] band from the observed size range
    (reference computeSize semantics, src/FeatureExtractor.cpp:132-142).
    """
    kp_path, sc_path, de_path = feature_paths(image_path, subdir)
    kps = load_bin(kp_path, 3)
    scores = load_bin(sc_path, 1)[:, 0]
    descs = load_bin(de_path, desc_dim)
    n = min(len(kps), len(scores), len(descs))
    kps, scores, descs = kps[:n], scores[:n], descs[:n]

    order = np.argsort(-scores, kind="stable")[:capacity]
    kps, scores, descs = kps[order], scores[order], descs[order]
    n = len(kps)

    sizes_raw = kps[:, 2].astype(np.float32)
    lo, hi = float(sizes_raw.min(initial=1.0)), float(sizes_raw.max(initial=1.0))
    if hi > lo:
        size = 1.0 + (sizes_raw - lo) * (ORB_MAX_SIZE - 1.0) / (hi - lo)
    else:
        size = np.full(n, ORB_MAX_SIZE, np.float32)

    out = dict(
        xy=np.zeros((capacity, 2), np.float32),
        resp=np.zeros(capacity, np.float32),
        octave=np.zeros(capacity, np.int32),
        angle=np.zeros(capacity, np.float32),
        size=np.ones(capacity, np.float32),
        sigma2=np.ones(capacity, np.float32),
        inv_sigma2=np.zeros(capacity, np.float32),
        desc_bits=np.zeros((capacity, desc_dim), np.float32),
        valid=np.zeros(capacity, bool),
    )
    out["xy"][:n] = kps[:, :2]
    out["resp"][:n] = scores
    out["size"][:n] = size
    out["sigma2"][:n] = size * size
    out["inv_sigma2"][:n] = 1.0 / (size * size)
    out["desc_bits"][:n] = descs
    out["valid"][:n] = True
    return out
