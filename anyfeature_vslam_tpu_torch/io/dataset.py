"""Sequence loading: rgb.txt / rgb.csv listings, calibration YAML, images
(port of anyfeature_vslam_tpu/io/dataset.py, monocular part).

Covers the reference's two dataset layouts:
  - TUM-style ``rgb.txt`` ("<timestamp> <relative path>" lines; reference
    docs/toy_sequence/rgb.txt, loaded by LoadImages at
    src/vslamlab_anyfeature_mono.cpp:206-255)
  - VSLAM-LAB ``rgb.csv`` with header-mapped columns ``ts_rgb_0 (ns)`` and
    ``path_rgb_0``.
Calibration is the flat OpenCV-style YAML (Camera.fx .. Camera.k3, w/h, fps).
The camera comes back as the port's ``CameraParams`` on the CPU; ``System``
moves it to its device. ``find_vocabulary`` looks a feature's vocabulary up
in a reference-style folder. PIL is imported only inside ``load_gray``, so the
module imports on machines without it.
"""

from __future__ import annotations

import csv
import os
import re
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..ops.camera import CameraParams


@dataclass
class Sequence:
    timestamps: List[float]  # seconds
    image_paths: List[str]
    camera: CameraParams
    fps: float


def _parse_flat_yaml(path: str) -> dict:
    """Parse 'Key: value' YAML subset (handles the %YAML directive + comments)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            m = re.match(r"^([\w.]+)\s*:\s*(.+)$", line)
            if m:
                key, val = m.group(1), m.group(2).strip().strip('"')
                try:
                    out[key] = float(val)
                except ValueError:
                    out[key] = val
    return out


def load_calibration(path: str) -> Tuple[CameraParams, float]:
    y = _parse_flat_yaml(path)
    cam = CameraParams.create(
        fx=y["Camera.fx"], fy=y["Camera.fy"], cx=y["Camera.cx"], cy=y["Camera.cy"],
        k1=y.get("Camera.k1", 0.0), k2=y.get("Camera.k2", 0.0),
        p1=y.get("Camera.p1", 0.0), p2=y.get("Camera.p2", 0.0),
        k3=y.get("Camera.k3", 0.0),
        width=int(y.get("Camera.w", 640)), height=int(y.get("Camera.h", 480)),
        device="cpu",
    )
    return cam, float(y.get("Camera.fps", 30.0))


def load_sequence(sequence_path: str, calibration_yaml: str | None = None,
                  rgb_csv: str | None = None) -> Sequence:
    """Load a sequence; `calibration_yaml` / `rgb_csv` override the default
    in-sequence files (reference CLI args calibration_yaml: / rgb_csv:,
    src/vslamlab_anyfeature_mono.cpp:55-66)."""
    cam, fps = load_calibration(
        calibration_yaml or os.path.join(sequence_path, "calibration.yaml")
    )
    ts, paths = [], []
    csv_path = rgb_csv or os.path.join(sequence_path, "rgb.csv")
    txt_path = os.path.join(sequence_path, "rgb.txt")
    if os.path.exists(csv_path):
        with open(csv_path) as f:
            reader = csv.DictReader(f)
            ts_col = next(c for c in reader.fieldnames if c.startswith("ts_rgb_0"))
            path_col = next(c for c in reader.fieldnames if c.startswith("path_rgb_0"))
            for row in reader:
                ts.append(float(row[ts_col]) * 1e-9)  # ns -> s
                paths.append(os.path.join(sequence_path, row[path_col]))
    elif os.path.exists(txt_path):
        with open(txt_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, rel = line.split()[:2]
                ts.append(float(t))
                paths.append(os.path.join(sequence_path, rel))
    else:
        raise FileNotFoundError(f"no rgb.csv or rgb.txt in {sequence_path}")
    return Sequence(ts, paths, cam, fps)


def load_gray(path: str) -> np.ndarray:
    """Load an image as float32 grayscale (H, W) in [0, 255] with the
    cv::cvtColor weights 0.299 R + 0.587 G + 0.114 B."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "L":
        arr = np.asarray(img.convert("RGB"), dtype=np.float32)
        gray = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
    else:
        gray = np.asarray(img, dtype=np.float32)
    return gray.astype(np.float32)


def load_feature_settings(path: str) -> dict:
    """Per-feature settings YAML with the reference's 4 knobs
    (settings/*_settings.yaml). Returns only the keys present."""
    y = _parse_flat_yaml(path)
    out = {}
    if "FeatureExtractor.numOctaves" in y:
        out["n_levels"] = int(y["FeatureExtractor.numOctaves"])
    if "FeatureExtractor.scaleFactor" in y:
        out["scale_factor"] = float(y["FeatureExtractor.scaleFactor"])
    if "FeatureExtractor.detectionTh" in y:
        out["detect_th"] = float(y["FeatureExtractor.detectionTh"])
    if "FeatureMatcher.matchingTh" in y:
        out["match_th"] = float(y["FeatureMatcher.matchingTh"])
    return out


# reference per-feature DBoW2 vocabulary file names (src/Vocabulary.cpp)
VOCAB_FILENAMES = {
    "orb32": "ORBvoc.txt",
    "akaze61": "Akaze61_DBoW2_voc.txt",
    "brisk48": "Brisk_DBoW2_voc.txt",
    "surf64": "Surf64_DBoW2_voc.txt",
    "kaze64": "Kaze64_DBoW2_voc.txt",
    "sift128": "Sift128_DBoW2_voc.txt",
    "r2d2_128": "R2d2_DBoW2_voc.txt",
    "anyfeat_bin": "AnyFeatBin_DBoW2_voc.txt",
    "anyfeat_nonbin": "AnyFeatNonBin_DBoW2_voc.txt",
}


def find_vocabulary(folder: str, feature: str) -> str | None:
    """Locate a vocabulary for `feature` in a reference-style vocabulary
    folder: the DBoW2 text name first, then a framework-native .npz."""
    cands = []
    if feature in VOCAB_FILENAMES:
        cands.append(os.path.join(folder, VOCAB_FILENAMES[feature]))
    cands.append(os.path.join(folder, f"{feature}_voc.npz"))
    for c in cands:
        if os.path.exists(c):
            return c
    return None
