"""System facade: wires tracking, local mapping, place recognition and
loop closing, runs sequences, saves output and checkpoints (port of
anyfeature_vslam_tpu/system.py, synchronous monocular).

The counterpart of the reference ``System`` (include/System.h:52,
src/System.cc): builds the map, the tracker and the local mapper, loads
the vocabulary (by default the shipped ``vocabularies/voc_<feature>_*.npz``)
and with it the keyframe database (relocalization) and the loop closer,
routes frames and saves trajectories, statistics and checkpoints. Each
frame is tracked to its end and each keyframe event (local mapping, then
the loop stage) runs to its end before the next frame (the JAX package's
``async_mapping=False, threaded_mapping=False``, pipeline depth 0), so a
run is deterministic. Everything the JAX constructor accepts is accepted
here; values of parts not yet ported raise NotImplementedError naming the
ROADMAP.md queue item that ports them. The one default that differs from
the JAX package's is ``async_mapping=False`` (asynchronous and threaded
mapping are queue item 8); ``use_mesh`` never builds a mesh.
"""

from __future__ import annotations

import glob
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from .convert import camera_from_numpy
from .frontend.extractor import FEATURE_REGISTRY, ExtractorConfig, descriptor_dim
from .io import dataset, trajectory
from .place_recognition.database import KeyFrameDatabase
from .place_recognition.vocab import Vocabulary, train_vocabulary
from .slam.local_mapping import LocalMapper
from .slam.loop_closing import LoopCloser
from .slam.map_state import SlamMap
from .slam.tracking import Tracker, TrackingConfig, TrackState


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to the torch package yet: ROADMAP.md "
                              f"queue item {item}")


def _default_vocabulary(feature: str) -> str | None:
    """The shipped vocabulary of a feature family, if present (the repo's
    ``vocabularies/`` folder; the reference ships one DBoW2 file per
    feature, src/Vocabulary.cpp:54-106)."""
    vdir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "vocabularies")
    hits = sorted(glob.glob(os.path.join(vdir, f"voc_{feature}_*.npz")))
    return hits[-1] if hits else None


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
        enable_loop_closing: bool = True,
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
        CPU. vocabulary_path None: the shipped vocabulary of `feature`."""
        if feature not in FEATURE_REGISTRY:
            raise ValueError(f"unknown feature type: {feature} (known: {sorted(FEATURE_REGISTRY)})")
        if sensor not in ("monocular", "rgbd", "stereo"):
            raise ValueError(f"unknown sensor: {sensor}")
        if sensor != "monocular":
            _not_ported(f"sensor={sensor!r} (RGB-D and stereo tracking)", "10")
        if async_mapping or threaded_mapping or pipeline_depth:
            _not_ported("asynchronous mapping, threaded mapping and pipelined tracking", "8")
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
        self.seed = seed
        self.match_th = match_th
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
        self.tracker.on_reset = self._on_reset
        self.cam_host = cam_host
        self.frame_times: list[float] = []
        self.mapping_times: list[float] = []
        self.loop_times: list[float] = []
        self._last_map_change_idx = 0
        # place recognition: the given vocabulary, else the shipped one for
        # this feature family, else one trained from the map once it has
        # enough descriptors (_maybe_train_vocabulary)
        if vocabulary_path is None:
            vocabulary_path = _default_vocabulary(feature)
        self.vocabulary = vocabulary_path and Vocabulary.load(vocabulary_path)
        self.database = None
        self.loop_closer = None
        self.loop_closing_enabled = enable_loop_closing
        if self.vocabulary is not None:
            self._enable_place_recognition()

    def _enable_place_recognition(self):
        """The keyframe database (relocalization; culled keyframes leave it,
        reference KeyFrame::SetBadFlag -> KeyFrameDatabase::erase) and, when
        enabled, the loop closer."""
        self.database = KeyFrameDatabase(self.vocabulary, self.map.max_kf, device=self.device)
        self.tracker.database = self.database
        self.map.on_kf_removed = self.database.erase
        for kf in self.map.keyframe_ids():
            self.database.add(int(kf), self.map.kf_desc_bits[kf], self.map.kf_feat_valid[kf])
        if self.loop_closing_enabled:
            self.loop_closer = LoopCloser(self.map, self.cam_host, self.database,
                                          match_th=self.match_th, seed=self.seed,
                                          device=self.device, kf_dev=self.local_mapper.kf_dev)

    def _maybe_train_vocabulary(self):
        """Without a vocabulary, train one from the keyframes' descriptors
        once there are enough of them (branching 32, depth 2)."""
        if self.vocabulary is not None or self.map.n_keyframes() < 4:
            return
        descs = np.concatenate([self.map.kf_desc_bits[kf][self.map.kf_feat_valid[kf]]
                                for kf in self.map.keyframe_ids()])
        if len(descs) < 2000:
            return
        self.vocabulary = train_vocabulary(descs, branching=32, depth=2, iters=5, seed=self.seed)
        self._enable_place_recognition()

    def _on_new_keyframe(self, kf):
        """The keyframe event: local mapping, then the loop stage (BoW,
        detection, and a correction when a loop closes)."""
        t0 = time.perf_counter()
        self.local_mapper.process_keyframe(kf)
        self.mapping_times.append(time.perf_counter() - t0)
        self._maybe_train_vocabulary()
        if self.loop_closer is not None:
            t1 = time.perf_counter()
            self.loop_closer.process_keyframe(kf)
            self.loop_times.append(time.perf_counter() - t1)
        elif self.database is not None:
            self.database.add(kf, self.map.kf_desc_bits[kf], self.map.kf_feat_valid[kf])

    def map_changed(self) -> bool:
        """Reference System::MapChanged (include/System.h:94): true once per
        big map change (a loop closure with its global BA)."""
        idx = self.map.change_idx
        if idx > self._last_map_change_idx:
            self._last_map_change_idx = idx
            return True
        return False

    def reset(self):
        """Clear the map, the database and the tracking state (reference
        System::Reset -> Tracking::Reset, src/Tracking.cc:1311-1356)."""
        self.tracker._reset()

    def _on_reset(self):
        """After any map reset (a request, or tracking lost with at most 5
        keyframes): forget the local mapper's state and start a fresh
        database and loop closer on the empty map."""
        self.local_mapper.reset()
        if self.vocabulary is not None:
            self._enable_place_recognition()

    def save_checkpoint(self, path: str):
        """The whole map in the JAX package's checkpoint format
        (SlamMap.save)."""
        self.map.save(path)

    def load_checkpoint(self, path: str):
        """Restore a map saved by either package in place; tracking resumes
        by relocalization or a fresh initialization. The local mapper's
        keyframe cache, the tracker's device snapshots and the point mirror
        start over, and the loaded keyframes enter the database."""
        loaded = SlamMap.load(path, device=self.device)
        on_removed = self.map.on_kf_removed
        self.map.__dict__.update(loaded.__dict__)
        self.map.on_kf_removed = on_removed
        self.local_mapper.reset()
        self.tracker._fast_state = None
        self.tracker._chain = None
        if self.database is not None:
            for kf in self.map.keyframe_ids():
                self.database.add(int(kf), self.map.kf_desc_bits[kf], self.map.kf_feat_valid[kf])

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
        stats["loopClosures"] = self.loop_closer.n_loops_closed if self.loop_closer else 0
        if self.frame_times:
            stats["medianTrackingTime_s"] = round(float(np.median(self.frame_times)), 4)
            stats["meanTrackingTime_s"] = round(float(np.mean(self.frame_times)), 4)
        if self.mapping_times:
            stats["medianLocalMappingTime_s"] = round(float(np.median(self.mapping_times)), 4)
        if self.loop_times:
            stats["medianLoopClosingTime_s"] = round(float(np.median(self.loop_times)), 4)
        trajectory.save_statistics_yaml(os.path.join(out_dir, f"{exp_id}_statistics.yaml"),
                                        self.map, stats)
        return kf_csv


def run_sequence(sequence_path: str, feature: str = "orb32", out_dir: str | None = None,
                 exp_id: str = "exp", max_frames: int | None = None, verbose: bool = True,
                 calibration_yaml: str | None = None, rgb_csv: str | None = None,
                 feature_yaml: str | None = None, vocabulary_folder: str | None = None,
                 n_features: int | None = None, pace: bool = False, device="cuda"):
    """End-to-end: load a sequence, run SLAM on `device`, save the
    trajectories. Returns the System. vocabulary_folder: a reference-style
    folder to take the feature's vocabulary from (dataset.find_vocabulary;
    the shipped one otherwise). pace=True replays in real time (the loop
    sleeps to the frames' timestamps, reference
    src/vslamlab_anyfeature_mono.cpp:161-169)."""
    seq = dataset.load_sequence(sequence_path, calibration_yaml=calibration_yaml,
                                rgb_csv=rgb_csv)
    feature_settings = dataset.load_feature_settings(feature_yaml) if feature_yaml else None
    vocabulary_path = (dataset.find_vocabulary(vocabulary_folder, feature)
                       if vocabulary_folder else None)
    system = System(seq.camera, feature=feature, fps=seq.fps, feature_settings=feature_settings,
                    vocabulary_path=vocabulary_path, n_features=n_features, device=device)
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
