"""System facade: wires tracking and local mapping, runs sequences, saves
output (port of anyfeature_vslam_tpu/system.py, synchronous monocular).

The counterpart of the reference ``System`` (include/System.h:52,
src/System.cc): builds the map, the tracker and the local mapper, routes
frames and saves trajectories and statistics. Each frame is tracked to its
end and each keyframe event runs to its end before the next frame (the JAX
package's ``async_mapping=False, threaded_mapping=False``, pipeline depth
0), so a run is deterministic. Everything the JAX constructor accepts is
accepted here; values of parts not yet ported raise NotImplementedError
naming the ROADMAP.md queue item that ports them. Defaults that differ
from the JAX package's: ``async_mapping=False`` and
``enable_loop_closing=False`` (the only values ported), and ``use_mesh``
never builds a mesh.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from .convert import camera_from_numpy
from .frontend.extractor import FEATURE_REGISTRY, ExtractorConfig, descriptor_dim
from .io import dataset, trajectory
from .slam.local_mapping import LocalMapper
from .slam.map_state import SlamMap
from .slam.tracking import Tracker, TrackingConfig, TrackState


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to the torch package yet: ROADMAP.md "
                              f"queue item {item}")


class System:
    def __init__(
        self,
        camera,
        feature: str = "orb32",
        n_features: int | None = None,
        max_kf: int = 512,
        max_pt: int = 60000,
        seed: int = 0,
        fps: float = 30.0,
        vocabulary_path: str | None = None,
        enable_loop_closing: bool = False,
        feature_settings: dict | None = None,
        use_mesh: bool | str = "auto",
        sensor: str = "monocular",
        bf: float = 0.0,
        th_depth: float = 0.0,
        depth_map_factor: float = 1.0,
        async_mapping: bool = False,
        threaded_mapping: bool = False,
        pipeline_depth: int | None = None,
        device="cuda",
    ):
        """camera: the port's CameraParams (or anything with fx, fy, cx,
        cy, k1, k2, p1, p2, k3, width, height as numbers or CPU 0-d
        tensors). Runs on `device`, the card unless the caller names the
        CPU."""
        if feature not in FEATURE_REGISTRY:
            raise ValueError(f"unknown feature type: {feature} (known: {sorted(FEATURE_REGISTRY)})")
        if sensor not in ("monocular", "rgbd", "stereo"):
            raise ValueError(f"unknown sensor: {sensor}")
        if sensor != "monocular":
            _not_ported(f"sensor={sensor!r} (RGB-D and stereo tracking)", "10")
        if async_mapping or threaded_mapping or pipeline_depth:
            _not_ported("asynchronous mapping, threaded mapping and pipelined tracking", "8")
        if enable_loop_closing:
            _not_ported("loop closing", "7")
        if vocabulary_path is not None:
            _not_ported("place recognition (a vocabulary)", "6")
        if use_mesh is True:
            _not_ported("bundle adjustment over a device mesh", "12")
        detector, descriptor, n_oct, scale, detect_th, match_th = FEATURE_REGISTRY[feature]
        if feature_settings:
            n_oct = feature_settings.get("n_levels", n_oct)
            scale = feature_settings.get("scale_factor", scale)
            detect_th = feature_settings.get("detect_th", detect_th)
            match_th = feature_settings.get("match_th", match_th)
        if n_features is None:
            # reference Tracking.cc:1515-1520: 1000 below 310k px, 2000 above
            n_features = 2000 if camera.width * camera.height > 310000 else 1000
        self.device = torch.device(device)
        cam_host = SimpleNamespace(**{k: float(getattr(camera, k)) for k in (
            "fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")},
            width=int(camera.width), height=int(camera.height))
        self.camera = camera_from_numpy(cam_host, self.device)
        cfg = TrackingConfig(
            n_features=n_features, max_frames=max(int(round(fps)), 1), match_th=match_th,
            detect_th=detect_th, n_levels=n_oct, scale_factor=scale, detector=detector,
            descriptor=descriptor, seed=seed,
        )
        capacity = ExtractorConfig(n_features=n_features, n_levels=n_oct,
                                   scale_factor=scale).capacity
        self.map = SlamMap(max_kf=max_kf, max_pt=max_pt, n_feat=capacity,
                           desc_dim=descriptor_dim(descriptor), desc_dtype=np.uint8,
                           device=self.device)
        self.tracker = Tracker(cfg, self.camera, self.map, self.device)
        self.local_mapper = LocalMapper(
            self.map, self.tracker.intrinsics, cam_host.width, cam_host.height,
            match_th=match_th, size_tolerance=scale, device=self.device)
        self.tracker.on_new_keyframe = self._on_new_keyframe
        self.tracker.on_keyframe_feats = self.local_mapper.seed_kf_device
        self.tracker.kf_dev = self.local_mapper.kf_dev
        self.tracker.on_reset = self.local_mapper.reset
        self.frame_times: list[float] = []
        self.mapping_times: list[float] = []

    def _on_new_keyframe(self, kf):
        t0 = time.perf_counter()
        self.local_mapper.process_keyframe(kf)
        self.mapping_times.append(time.perf_counter() - t0)

    def track_monocular(self, img, ts: float) -> TrackState:
        """Track one (H, W) uint8 or float image (numpy, or a tensor)."""
        t0 = time.perf_counter()
        state = self.tracker.process_frame(img, ts)
        self.frame_times.append(time.perf_counter() - t0)
        return state

    # ------------------------------------------------------------- output
    def save_outputs(self, out_dir: str, exp_id: str = "exp"):
        """Keyframe trajectory CSV, frame trajectories (TUM, KITTI) and the
        statistics YAML. The map SVG of the JAX package's viewer is ROADMAP
        queue item 11."""
        os.makedirs(out_dir, exist_ok=True)
        kf_csv = os.path.join(out_dir, f"{exp_id}_KeyFrameTrajectory.csv")
        trajectory.save_keyframe_trajectory_vslamlab(kf_csv, self.map)
        trajectory.save_frame_trajectory_tum(
            os.path.join(out_dir, f"{exp_id}_FrameTrajectory_TUM.txt"), self.tracker.trajectory,
            self.map)
        trajectory.save_frame_trajectory_kitti(
            os.path.join(out_dir, f"{exp_id}_FrameTrajectory_KITTI.txt"),
            self.tracker.trajectory, self.map)
        stats = dict(self.tracker.stats)
        stats["loopClosures"] = 0
        if self.frame_times:
            stats["medianTrackingTime_s"] = round(float(np.median(self.frame_times)), 4)
            stats["meanTrackingTime_s"] = round(float(np.mean(self.frame_times)), 4)
        if self.mapping_times:
            stats["medianLocalMappingTime_s"] = round(float(np.median(self.mapping_times)), 4)
        trajectory.save_statistics_yaml(os.path.join(out_dir, f"{exp_id}_statistics.yaml"),
                                        self.map, stats)
        return kf_csv


def run_sequence(sequence_path: str, feature: str = "orb32", out_dir: str | None = None,
                 exp_id: str = "exp", max_frames: int | None = None, verbose: bool = True,
                 calibration_yaml: str | None = None, rgb_csv: str | None = None,
                 feature_yaml: str | None = None, n_features: int | None = None,
                 pace: bool = False, device="cuda"):
    """End-to-end: load a sequence, run SLAM on `device`, save the
    trajectories. Returns the System. pace=True replays in real time (the
    loop sleeps to the frames' timestamps, reference
    src/vslamlab_anyfeature_mono.cpp:161-169)."""
    seq = dataset.load_sequence(sequence_path, calibration_yaml=calibration_yaml,
                                rgb_csv=rgb_csv)
    feature_settings = dataset.load_feature_settings(feature_yaml) if feature_yaml else None
    system = System(seq.camera, feature=feature, fps=seq.fps, feature_settings=feature_settings,
                    n_features=n_features, device=device)
    n = len(seq.image_paths) if max_frames is None else min(max_frames, len(seq.image_paths))
    t_start = time.perf_counter()
    for i in range(n):
        if pace and i > 0:
            lag = seq.timestamps[i] - seq.timestamps[0] - (time.perf_counter() - t_start)
            if lag > 0:
                time.sleep(lag)
        state = system.track_monocular(dataset.load_gray(seq.image_paths[i]), seq.timestamps[i])
        if verbose:
            print(f"frame {i}/{n} state={state.name} kfs={system.map.n_keyframes()} "
                  f"pts={system.map.n_points()} inliers={system.tracker.n_inliers}", flush=True)
    if out_dir is not None:
        system.save_outputs(out_dir, exp_id)
    return system
