"""System facade: wires tracking, local mapping, place recognition and
loop closing, runs sequences, saves output and checkpoints (port of
anyfeature_vslam_tpu/system.py).

The counterpart of the reference ``System`` (include/System.h:52,
src/System.cc): builds the map, the tracker and the local mapper, loads
the vocabulary (by default the shipped ``vocabularies/voc_<feature>_*.npz``)
and with it the keyframe database (relocalization) and the loop closer,
routes frames (``track_monocular``, ``track_rgbd``, ``track_stereo`` by
``sensor``) and saves trajectories, statistics and checkpoints;
``activate_localization_mode`` stops mapping from the next frame on. Its
defaults are the JAX System's. Three schedules:

- ``async_mapping=False``: each frame and each keyframe event (local
  mapping, then the loop stage) runs to its end: deterministic.
- ``async_mapping=True`` (the default): the event's local-BA solve (and a
  loop closure's global BA) is issued on the mapping stream and folds back
  before the next map mutation; while it runs, the keyframe decision sees
  mapping busy.
- ``threaded_mapping=True``: the whole event runs on a worker thread
  (``_MappingWorker``, the reference's LocalMapping and LoopClosing
  threads), the tracker is pipelined (``pipeline_depth`` 2 by default),
  the loop stage's BoW folds one keyframe late, and a watcher thread lands
  each fold as soon as its results are on the host. One reentrant map lock
  serializes the structural map mutations; the event holds it only around
  them.

On the card the tracker runs on a stream of its own and the mapping side
on another (streams.py). With a mesh (``use_mesh``, ``_make_mesh``) local
and global BA run observation-sharded over the ranks of a torch.distributed
process group (parallel/sharded_ba.py); every rank runs the same System.
"""

from __future__ import annotations

import contextlib
import glob
import os
import queue
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from . import native, perfcount, streams
from .convert import camera_from_numpy
from .frontend.extractor import (FEATURE_REGISTRY, ExtractorConfig, descriptor_dim,
                                 descriptor_dtype)
from .io import dataset, trajectory, viewer
from .parallel import sharded_ba
from .place_recognition.database import KeyFrameDatabase
from .place_recognition.vocab import Vocabulary, train_vocabulary
from .slam.local_mapping import LocalMapper
from .slam.loop_closing import LoopCloser
from .slam.map_state import SlamMap
from .slam.tracking import Tracker, TrackingConfig, TrackState, image_uint8


class _Turns:
    """A first-come, first-served lock: the tracker takes it for a frame,
    the mapping worker for an event. Eager PyTorch issues every kernel from
    Python, and each op releases and retakes the GIL, so two threads issuing
    at once trade the GIL at every op; on the card that made both 3-5x
    slower (PERF.md). Taking turns at frame and event granularity keeps
    each issue stream on the GIL; the order of the turns is the order they
    were asked for, so neither thread starves."""

    def __init__(self):
        self._cv = threading.Condition()
        self._next = 0
        self._serving = 0

    def __enter__(self):
        with self._cv:
            ticket = self._next
            self._next += 1
            while ticket != self._serving:
                self._cv.wait()
        return self

    def __exit__(self, *exc):
        with self._cv:
            self._serving += 1
            self._cv.notify_all()
        return False

    @contextlib.contextmanager
    def turn(self, wait_span: str):
        """A turn whose wait for the ticket is the span `wait_span`."""
        with perfcount.span(wait_span):
            self.__enter__()
        try:
            yield self
        finally:
            self.__exit__()


class _MappingWorker:
    """The mapping thread (the reference's LocalMapping and LoopClosing
    threads, src/System.cc:112-117): keyframes queued by the tracker, the
    whole event run here on `stream`, in a turn of `turns` (taken between
    the tracker's frames). An exception in an event surfaces on the next
    submit or flush."""

    def __init__(self, event_fn, stream, turns: _Turns):
        self._event = event_fn
        self._stream = stream
        self._turns = turns
        self._q: queue.Queue = queue.Queue()
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._error = None
        self.max_pending = 0
        self._thread = threading.Thread(target=self._run, daemon=True, name="mapping")
        self._thread.start()

    def pending(self) -> int:
        return self._pending

    def _raise_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, kf: int):
        self._raise_error()
        with self._pending_lock:
            self._pending += 1
            self.max_pending = max(self.max_pending, self._pending)
        self._q.put(kf)

    def flush(self, timeout: float | None = None):
        """Block until every queued keyframe has been processed; raise
        TimeoutError after `timeout` seconds."""
        t_end = None if timeout is None else time.perf_counter() + timeout
        while self._pending > 0 and self._thread.is_alive():
            if t_end is not None and time.perf_counter() > t_end:
                raise TimeoutError(f"the mapping worker still has {self._pending} events")
            time.sleep(0.001)
        self._raise_error()

    def stop(self, timeout: float = 5.0) -> bool:
        """Drain, then stop the thread; True if it stopped within `timeout`."""
        try:
            self.flush(timeout)
        finally:
            self._q.put(None)
            self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    def _run(self):
        with streams.use(self._stream):
            while True:
                kf = self._q.get()
                if kf is None:
                    return
                try:
                    with self._turns:
                        self._event(kf)
                except BaseException as e:  # surfaced on the next submit or flush
                    self._error = e
                finally:
                    with self._pending_lock:
                        self._pending -= 1


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
        async_mapping: bool = True,
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
        if sensor != "monocular" and bf <= 0:
            raise ValueError("rgbd/stereo sensors need bf = baseline * fx > 0")
        if sensor != "monocular" and th_depth <= 0:
            # ORB-SLAM2's default: 35 baselines (ThDepth = 35, reference
            # Tracking.cc:1460; mThDepth = bf * ThDepth / fx)
            th_depth = 35.0 * bf / float(camera.fx)
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
        self.mesh = self._make_mesh(use_mesh, self.device)
        self.seed = seed
        self.match_th = match_th
        cam_host = SimpleNamespace(**{k: float(getattr(camera, k)) for k in (
            "fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")},
            width=int(camera.width), height=int(camera.height))
        self.camera = camera_from_numpy(cam_host, self.device)
        cfg = TrackingConfig(
            n_features=n_features, sensor=sensor, bf=bf, th_depth=th_depth,
            max_frames=max(int(round(fps)), 1), match_th=match_th,
            detect_th=detect_th, n_levels=n_oct, scale_factor=scale, detector=detector,
            descriptor=descriptor, seed=seed,
        )
        capacity = ExtractorConfig(n_features=n_features, n_levels=n_oct,
                                   scale_factor=scale).capacity
        self.map = SlamMap(max_kf=max_kf, max_pt=max_pt, n_feat=capacity,
                           desc_dim=descriptor_dim(descriptor),
                           desc_dtype=descriptor_dtype(descriptor),
                           device=self.device)
        # one reentrant lock serializes every structural map mutation:
        # keyframe minting, the event's mutation windows, folds, loop
        # correction (uncontended without a worker)
        self.map_lock = threading.RLock()
        self.tracker = Tracker(cfg, self.camera, self.map, self.device)
        self.tracker.map_lock = self.map_lock
        self.local_mapper = LocalMapper(
            self.map, self.tracker.intrinsics, cam_host.width, cam_host.height,
            match_th=match_th, size_tolerance=scale, sensor=sensor, th_depth=th_depth,
            device=self.device, lock=self.map_lock, mesh=self.mesh)
        self.tracker.on_new_keyframe = self._on_new_keyframe
        self.tracker.on_keyframe_feats = self.local_mapper.seed_kf_device
        self.tracker.kf_dev = self.local_mapper.kf_dev
        self.tracker.on_reset = self._on_reset
        self.tracker.mapping_idle = self.local_mapper.is_idle
        self.tracker.interrupt_mapping = self.local_mapper.fold_pending
        self.cam_host = cam_host
        self.sensor = sensor
        self.depth_map_factor = depth_map_factor
        self.async_mapping = async_mapping
        self.threaded_mapping = threaded_mapping
        if pipeline_depth is None:
            pipeline_depth = 2 if threaded_mapping else 0
        self.tracker.pipeline_depth = int(pipeline_depth)
        # the card's streams: the tracker's, and the mapping side's (the
        # deferred solves, the worker); none in the synchronous schedule
        concurrent = async_mapping or threaded_mapping or pipeline_depth > 0
        self._track_stream = streams.new_stream(self.device) if concurrent else None
        self._map_stream = streams.new_stream(self.device) if concurrent else None
        self.local_mapper.stream = self._map_stream
        self._worker = None
        # the tracker's and the worker's turns (uncontended without a worker)
        self._turns = _Turns()
        if threaded_mapping:
            self._worker = _MappingWorker(self._mapping_event, self._map_stream, self._turns)
            # busy while the worker has an event or a fold has not landed
            # (the reference's AcceptKeyFrames covers both)
            self.tracker.mapping_idle = lambda: (
                (self._worker is None or self._worker.pending() == 0)
                and self.local_mapper.is_idle())
            self.tracker.snapshot_safe = lambda: not self.local_mapper.in_sparse_phase
            self.tracker.map_fresh_check = lambda: self.local_mapper.fresh_event

            def _fresh_clear(token):
                with self.map_lock:
                    if token and self.local_mapper.fresh_event == token:
                        self.local_mapper.fresh_event = 0

            self.tracker.map_fresh_clear = _fresh_clear
            # a running worker event is not aborted: the keyframe lands when
            # the worker goes idle
            self.tracker.interrupt_mapping = lambda: None
        self._reset_requested = False
        self._activate_localization_requested = False
        self._deactivate_localization_requested = False
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

    @staticmethod
    def _make_mesh(use_mesh, device):
        """The process group local and global BA are sharded over
        (parallel/sharded_ba.py). False: none. "auto": the default group
        when one is initialized with two or more ranks. True: the default
        group, or a one-rank group (NCCL on the card, gloo on the CPU) when
        none is initialized; raises if no group can be made. Every rank
        runs the same System on the same frames: each sharded solve first
        checks that the ranks assembled the same problem, and raises if
        not. shutdown() destroys a group made here."""
        if use_mesh is False:
            return None
        if use_mesh == "auto":
            if not (dist.is_available() and dist.is_initialized()
                    and dist.get_world_size() >= 2):
                return None
        elif use_mesh is not True:
            raise ValueError(f"use_mesh must be True, False or 'auto', not {use_mesh!r}")
        if not dist.is_available():
            raise RuntimeError("use_mesh=True needs torch.distributed, which this torch lacks")
        return sharded_ba.make_mesh(device)

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
                                          device=self.device, kf_dev=self.local_mapper.kf_dev,
                                          lock=self.map_lock, mesh=self.mesh)
            self.loop_closer.stream = self._map_stream
            # threaded: the BoW folds one keyframe late, so no loop stage
            # waits on the device
            self.loop_closer.deferred_bow = self._worker is not None
            if self.async_mapping:
                self.loop_closer.defer_ba_sink = self._register_deferred_fold

    def _register_deferred_fold(self, fold):
        """Park a deferred global BA in the local mapper's pending-fold slot:
        it lands at the next event's flush (asynchronous mapping; a landing
        mid-frame would move poses under the tracker's host reads) or from a
        watcher thread under the map lock as soon as its results are on the
        host (threaded; the reference's detached GBA thread,
        src/LoopClosing.cc:589-593)."""
        self.local_mapper.fold_pending()
        self.local_mapper._pending_fold = fold
        if self._worker is not None:
            self.local_mapper.arm_fold_watcher()

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
        if self._worker is not None:
            # threaded: queue the event (reference LocalMapping::InsertKeyFrame)
            self._worker.submit(kf)
            return
        self._mapping_event(kf)

    def _mapping_event(self, kf):
        """The keyframe event: local mapping, then the loop stage (BoW,
        detection, and a correction when a loop closes)."""
        with perfcount.span("event", kf):
            t0 = time.perf_counter()
            self.local_mapper.process_keyframe(kf, defer_ba=self.async_mapping,
                                               overlap_results=self._worker is not None)
            if self._worker is not None:
                # the fold lands from a watcher thread as soon as the solve's
                # results are on the host
                self.local_mapper.arm_fold_watcher()
            self.mapping_times.append(time.perf_counter() - t0)
            with self.map_lock:
                self._maybe_train_vocabulary()
            if self.loop_closer is not None:
                t1 = time.perf_counter()
                self.loop_closer.process_keyframe(kf, pre_mutate=self.local_mapper.flush_results)
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
        System::Reset -> Tracking::Reset, src/Tracking.cc:1311-1356): the
        frames in flight are dropped, the worker drained."""
        self.tracker._inflight.clear()
        if self._worker is not None:
            self._worker.flush()
        with self.map_lock:
            self.tracker._reset()

    def request_reset(self):
        """Reset before the next frame (reference System::Reset)."""
        self._reset_requested = True

    def _on_reset(self):
        """After any map reset (a request, or tracking lost with at most 5
        keyframes): forget the local mapper's state (a pending fold
        included) and start a fresh database and loop closer on the empty
        map."""
        with self.map_lock:
            self.local_mapper.reset()
            if self.vocabulary is not None:
                self._enable_place_recognition()

    def _drain(self):
        """Retire the frames in flight, drain the worker, land the pending
        fold and BoW."""
        with self._turns, streams.use(self._track_stream):
            self.tracker.flush_pipeline()
        if self._worker is not None:
            self._worker.flush()
        with self.map_lock:
            self.local_mapper.flush_results()
            if self.loop_closer is not None:
                self.loop_closer.flush_bow()

    def shutdown(self, timeout: float = 5.0):
        """Reference System::Shutdown (src/System.cc:332-351): retire the
        frames in flight, drain and stop the worker (each wait bounded by
        `timeout` seconds), land the pending fold and BoW, wait for the
        device, and destroy the process group that the mesh made."""
        with self._turns, streams.use(self._track_stream):
            self.tracker.flush_pipeline()
        if self._worker is not None:
            stopped = self._worker.stop(timeout)
            self._worker = None
            if not stopped:
                raise TimeoutError("the mapping worker did not stop")
        self._drain()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.mesh is not None:
            self.mesh.close()

    def save_checkpoint(self, path: str):
        """The whole map in the JAX package's checkpoint format
        (SlamMap.save), after the frames in flight and the pending folds."""
        self._drain()
        with self.map_lock:
            self.map.save(path)

    def load_checkpoint(self, path: str):
        """Restore a map saved by either package in place; tracking resumes
        by relocalization or a fresh initialization. The local mapper's
        keyframe cache and pending fold, the tracker's device snapshots and
        the point mirror start over, and the loaded keyframes enter the
        database."""
        self._drain()
        loaded = SlamMap.load(path, device=self.device)
        with self.map_lock:
            on_removed = self.map.on_kf_removed
            self.map.__dict__.update(loaded.__dict__)
            self.map.on_kf_removed = on_removed
            self.local_mapper.reset()
            self.tracker._fast_state = None
            self.tracker._chain = None
            if self.database is not None:
                for kf in self.map.keyframe_ids():
                    self.database.add(int(kf), self.map.kf_desc_bits[kf],
                                      self.map.kf_feat_valid[kf])

    def track_monocular(self, img, ts: float, image_path: str | None = None) -> TrackState:
        """Track one (H, W) uint8 or float image (numpy, or a tensor).
        image_path: the image's file, where precomputed features (r2d2_128)
        are found (io/precomputed.feature_paths); other families ignore it."""
        if self.sensor != "monocular":
            raise RuntimeError("track_monocular called but sensor is " + self.sensor)
        return self._track(img, ts, image_path=image_path)

    def track_rgbd(self, img, depth: np.ndarray, ts: float) -> TrackState:
        """Reference System::TrackRGBD (src/System.cc:192-241): an image and
        its registered depth map (host array, times depth_map_factor gives
        metres)."""
        if self.sensor != "rgbd":
            raise RuntimeError("track_rgbd called but sensor is " + self.sensor)
        if self.depth_map_factor != 1.0:
            depth = depth.astype(np.float32) * self.depth_map_factor
        return self._track(img, ts, depth=depth)

    def track_stereo(self, img_left, img_right, ts: float) -> TrackState:
        """Reference System::TrackStereo (src/System.cc:141-190): a
        rectified pair."""
        if self.sensor != "stereo":
            raise RuntimeError("track_stereo called but sensor is " + self.sensor)
        return self._track(img_left, ts, img_right=img_right)

    def _track(self, img, ts, image_path=None, depth=None, img_right=None) -> TrackState:
        fid = self.tracker.frame_id  # the id process_frame gives this frame
        with perfcount.span("frame", fid):
            # mode changes and a requested reset land before the frame
            # (reference System::TrackMonocular :253-285)
            if self._activate_localization_requested:
                self.tracker.only_tracking = True
                self._activate_localization_requested = False
            if self._deactivate_localization_requested:
                self.tracker.only_tracking = False
                self.tracker.mb_vo = False
                self._deactivate_localization_requested = False
            if self._reset_requested:
                self.reset()
                self._reset_requested = False
            # bootstrap barrier (threaded): while losing the map would reset
            # it (<= 5 keyframes, reference Tracking.cc:355-363), mapping
            # keeps up with tracking
            if self._worker is not None and self.map.n_keyframes() <= 5:
                with perfcount.span("frame.barrier"):
                    self._worker.flush()
            t0 = time.perf_counter()
            with self._turns.turn("frame.turn_wait"), streams.use(self._track_stream):
                state = self.tracker.process_frame(img, ts, image_path=image_path, depth=depth,
                                                   img_right=img_right)
            self.frame_times.append(time.perf_counter() - t0)
        return state

    # ---------------------------------------------------------- accessors
    def get_tracking_state(self) -> TrackState:
        """Reference System::GetTrackingState (include/System.h:128)."""
        return self.tracker.state

    def get_tracked_map_points(self) -> np.ndarray:
        """Point ids matched in the last retired frame (reference
        System::GetTrackedMapPoints, include/System.h:129)."""
        f = self.tracker.last
        if f is None or f.matches is None:
            return np.zeros(0, np.int32)
        return f.matches[f.matches >= 0]

    def get_tracked_keypoints_un(self) -> np.ndarray:
        """Undistorted keypoints of the last retired frame (reference
        System::GetTrackedKeyPointsUn, include/System.h:130)."""
        f = self.tracker.last
        if f is None:
            return np.zeros((0, 2), np.float32)
        return f.feats["uv_und"][f.feats["valid"]]

    def activate_localization_mode(self):
        """From the next frame on, stop mapping and track against the
        frozen map (reference System::ActivateLocalizationMode,
        include/System.h:88)."""
        self._activate_localization_requested = True

    def deactivate_localization_mode(self):
        """From the next frame on, map again."""
        self._deactivate_localization_requested = True

    # ------------------------------------------------------------- output
    def save_outputs(self, out_dir: str, exp_id: str = "exp"):
        """Keyframe trajectory CSV, frame trajectories (TUM, KITTI), the
        statistics YAML and the map SVG (io/viewer.py), after the frames in
        flight and the pending folds."""
        self._drain()
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
        viewer.render_map_svg(
            self.map, os.path.join(out_dir, f"{exp_id}_map.svg"),
            trajectory=viewer.trajectory_centers(self.tracker.trajectory, self.map))
        return kf_csv

    def render_frame(self, img: np.ndarray, path: str | None = None):
        """Overlay of the last retired frame's keypoints and tracks
        (reference FrameDrawer::DrawFrame): an (H, W, 3) uint8 array, also
        written as a PNG to `path` when given; None before any frame."""
        f = self.tracker.last
        if f is None:
            return None
        return viewer.render_frame_overlay(img, f.feats, f.matches,
                                           state_text=self.tracker.state.name, path=path)


def run_sequence(sequence_path: str, feature: str = "orb32", out_dir: str | None = None,
                 exp_id: str = "exp", max_frames: int | None = None, verbose: bool = True,
                 calibration_yaml: str | None = None, rgb_csv: str | None = None,
                 feature_yaml: str | None = None, vocabulary_folder: str | None = None,
                 sensor: str = "monocular", bf: float = 0.0, n_features: int | None = None,
                 pace: bool = False, threaded_mapping: bool = False, device="cuda"):
    """End-to-end: load a sequence, run SLAM on `device`, save the
    trajectories. Returns the System. vocabulary_folder: a reference-style
    folder to take the feature's vocabulary from (dataset.find_vocabulary;
    the shipped one otherwise). pace=True replays in real time (the loop
    sleeps to the frames' timestamps, reference
    src/vslamlab_anyfeature_mono.cpp:161-169). threaded_mapping: the
    System's worker-thread schedule. sensor="rgbd" reads a TUM RGB-D
    layout (rgb.txt + depth.txt, dataset.load_sequence_rgbd) and tracks
    each image with its depth map (System.track_rgbd; bf = baseline * fx).
    Images are read ahead on a reader thread (native.FrameLoader, as the
    JAX package's run_sequence; ``system.frame_loader`` keeps its decode and
    wait times); a depth map is read on this thread when its frame is
    tracked. On the card a monocular run takes the next frame's image and
    starts its upload (pinned, non_blocking, on the tracker's stream)
    before the current frame is tracked (not for precomputed features,
    which the tracker reads from the files beside each image)."""
    if sensor == "rgbd":
        seq = dataset.load_sequence_rgbd(sequence_path, calibration_yaml=calibration_yaml)
    else:
        seq = dataset.load_sequence(sequence_path, calibration_yaml=calibration_yaml,
                                    rgb_csv=rgb_csv)
    feature_settings = dataset.load_feature_settings(feature_yaml) if feature_yaml else None
    vocabulary_path = (dataset.find_vocabulary(vocabulary_folder, feature)
                       if vocabulary_folder else None)
    system = System(seq.camera, feature=feature, fps=seq.fps, feature_settings=feature_settings,
                    vocabulary_path=vocabulary_path, sensor=sensor, bf=bf,
                    n_features=n_features, threaded_mapping=threaded_mapping, device=device)
    n = len(seq.image_paths) if max_frames is None else min(max_frames, len(seq.image_paths))
    # precomputed features are read from files: no image upload to overlap
    prefetch = (system.device.type == "cuda" and sensor == "monocular"
                and not system.tracker.precomputed)
    loader = system.frame_loader = native.FrameLoader(seq.image_paths[:n], seq.camera.height,
                                                      seq.camera.width)

    def load(i):
        img = loader.get(i)
        if not prefetch:
            return img
        with streams.use(system._track_stream):
            return torch.from_numpy(image_uint8(img)).pin_memory().to(system.device,
                                                                       non_blocking=True)

    try:
        t_start = time.perf_counter()
        nxt = load(0) if n else None
        for i in range(n):
            if pace and i > 0:
                lag = seq.timestamps[i] - seq.timestamps[0] - (time.perf_counter() - t_start)
                if lag > 0:
                    time.sleep(lag)
            img = nxt
            if i + 1 < n:
                nxt = load(i + 1)
            if sensor == "rgbd":
                depth = dataset.load_depth(seq.depth_paths[i], seq.depth_factor)
                state = system.track_rgbd(img, depth, seq.timestamps[i])
            else:
                state = system.track_monocular(img, seq.timestamps[i],
                                               image_path=seq.image_paths[i])
            if verbose:
                print(f"frame {i}/{n} state={state.name} kfs={system.map.n_keyframes()} "
                      f"pts={system.map.n_points()} inliers={system.tracker.n_inliers}",
                      flush=True)
    finally:
        loader.close()
    if out_dir is not None:
        system.save_outputs(out_dir, exp_id)
    return system
