"""Tracking: the per-frame state machine (port of
anyfeature_vslam_tpu/slam/tracking.py).

The counterpart of the reference Tracking thread (reference
src/Tracking.cc): NOT_INITIALIZED -> OK -> LOST, with two-view
initialization (monocular) or an instant one from sensor depth (RGB-D,
stereo: ``_stereo_initialization``), the fused tracked frame
(slam/fast_track.py: motion-model search, reference-keyframe fallback,
local-map search, pose LMs), the staged per-stage path (the frame after
initialization, and every RGB-D, stereo or localization-mode frame, as
in the JAX package), and the keyframe decision (Tracking.cc:838-922)
with its close-point terms for depth sensors. An RGB-D frame samples its
depth map at the keypoints (``_attach_depth``); a stereo frame extracts
its right image too and matches rows with a sub-pixel SAD refinement
(``_attach_stereo``); their keyframes mint points from that depth
(``_create_depth_points``). In localization mode (``only_tracking``)
mapping stops: the motion model or the reference keyframe, then the
local map, and while few map points are matched (``mb_vo``) the motion
model rides the last frame's depth points (visual odometry) and
relocalization is tried at every frame (reference Tracking.cc:210-296).
The frame after the first initialization is held against the initial pair's motion, and an
initialization it shows to be ambiguous is rebuilt from the wider pair
(``_rebuild_ambiguous_initialization``; the port's own step).

With ``pipeline_depth=0`` each frame is tracked to its end. With a depth
d > 0 (the threaded System's default, 2) a tracked frame's fused step is
dispatched (``_fast_dispatch``: issued, its small outputs copied toward
the host behind a ``streams.Ready`` probe, the device chain carrying the
carry and the pose prediction to the next dispatch) and retired d frames
later (``_fast_retire``: bookkeeping, velocity, trajectory and the keyframe
decision); a retired failure replays the frame and its successors through
the sequential state machine (``_handle_fast_failure``). The keyframe
decision's c1b asks ``mapping_idle``, and a wanted keyframe while mapping
is busy calls ``interrupt_mapping`` (reference Tracking.cc:870-876,
905-918); keyframe minting and relocalization hold ``map_lock``. A LOST
frame relocalizes against the keyframe database
(``database``, set by the System with its vocabulary; without one it stays
LOST): BoW candidates, one K2 search per candidate, batched RANSAC-EPnP,
pose LM, projection add-match rounds and the local map (reference
Relocalization, src/Tracking.cc:1146-1309). Precomputed features
(r2d2_128) are read from the files beside each frame's image
(io/precomputed.py) on the host, uploaded once and undistorted on the
device; those frames take the staged path, as in the JAX package (the
fused step extracts in-program and cannot read files). Per-frame compute
runs on the tracker's device; the map and bookkeeping are numpy on the
host.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch

from .. import perfcount, streams
from ..frontend.extractor import ExtractorConfig, make_extractor
from ..io.precomputed import load_precomputed_features
from ..ops import camera as cam_ops
from ..ops import initializer, pnp, pose_opt
from . import fast_track, frame_ops
from .map_state import SlamMap


RELOC_MAX_CANDIDATES = 8   # the JAX package's fixed candidate capacity
RELOC_MIN_MATCHES = 15     # reference: >= 15 BoW matches per candidate
RELOC_MIN_PNP = 10         # reference: >= 10 PnP / pose-LM inliers
RELOC_GOOD = 50            # reference: success at >= 50 inliers
# the frame after a monocular initialization moves about as far per frame
# as the initial pair did (its first pose LM, before any BA, tends to fall
# short: 0.09-0.9 of that motion on the rendered bench scene at 320x240
# and 640x480); below this fraction it has not moved at all (0.022-0.029
# where anyfeat_bin initializes at 640x480, in both packages), and the
# initial map is rebuilt from the wider pair
# (``_rebuild_ambiguous_initialization``)
REINIT_MIN_MOTION = 0.05


class TrackState(Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class TrackingConfig:
    n_features: int = 1000
    sensor: str = "monocular"        # monocular | rgbd | stereo (System.h:54-60)
    bf: float = 0.0                  # baseline(m) * fx (reference mbf, Tracking.cc:1386)
    th_depth: float = 0.0            # close-point depth threshold (reference mThDepth)
    max_frames: int = 30             # maxFrames = fps (keyframe cadence)
    match_th: float = 75.0           # settings/orb32_settings.yaml matchingTh
    init_window: float = 100.0       # reference Tracking.cc:473
    init_ratio: float = 0.9
    min_init_matches: int = 100      # reference Tracking.cc:466
    min_init_tracked: int = 100      # reference Tracking.cc:554-559
    motion_radius: float = 15.0      # reference Tracking.cc:744 (th for mono)
    refkf_ratio: float = 0.7         # reference TrackReferenceKeyFrame matcher(0.7)
    local_ratio: float = 0.8         # reference SearchLocalPoints matcher(0.8)
    local_radius: float = 1.0        # reference th=1
    min_motion_matches: int = 20
    min_track_inliers: int = 10
    min_local_inliers: int = 30
    kf_ref_ratio: float = 0.9        # refRatio_high_needNewKey
    kf_min_inliers: int = 15         # minMatchesInliers
    max_local_kfs: int = 80
    local_pt_bucket: int = 4096
    detect_th: float = 20.0
    n_levels: int = 8
    scale_factor: float = 1.2
    detector: str = "fast"
    descriptor: str = "bin256"
    seed: int = 0


def _host(t):
    return t.cpu().numpy()


def _centre(t_cw):
    """Camera centre of a (4, 4) world->camera pose, float64."""
    t = t_cw.astype(np.float64)
    return -t[:3, :3].T @ t[:3, 3]


def image_uint8(img: np.ndarray) -> np.ndarray:
    """A host image as the tracker takes it: uint8, other dtypes clipped to
    [0, 255]."""
    return img if img.dtype == np.uint8 else np.clip(img, 0, 255).astype(np.uint8)


class DeviceFeats(dict):
    """Frame features as tensors on the device, with lazy host mirrors:
    ``feats.dev(k)`` is the tensor (what every search takes);
    ``feats[k]`` is a numpy copy, fetched on first access (all small
    fields at once; descriptors only when touched)."""

    _BULKY = ("desc_bits",)

    def __init__(self, devd: dict):
        super().__init__()
        self._dev = dict(devd)
        self._fetched_small = False

    def dev(self, k):
        return self._dev[k]

    def _fetch_small(self):
        for k in self._dev:
            if k not in self._BULKY and not super().__contains__(k):
                super().__setitem__(k, _host(self._dev[k]))
        self._fetched_small = True

    def __getitem__(self, k):
        if not super().__contains__(k):
            if k in self._BULKY and k in self._dev:
                super().__setitem__(k, _host(self._dev[k]))
            elif not self._fetched_small:
                self._fetch_small()
        return super().__getitem__(k)

    def __contains__(self, k):
        return super().__contains__(k) or k in self._dev

    def get(self, k, default=None):
        return self[k] if k in self else default

    def fetch_all(self):
        """Host copies of every field (keyframe insertion takes them all)."""
        for k in self._dev:
            self[k]
        return self

    def items(self):
        self.fetch_all()
        return super().items()


@dataclass
class FrameData:
    frame_id: int
    ts: float
    feats: DeviceFeats | None
    pose: np.ndarray | None = None       # Tcw 4x4
    matches: np.ndarray | None = None    # (N,) kp slot -> point id or -1
    # localization mode with depth: per-slot world positions from sensor
    # depth ("visual odometry" points), used by the pose LM and never
    # inserted into the map (reference mlpTemporalPoints, Tracking.cc:663-727)
    vo_pts3d: np.ndarray | None = None
    vo_valid: np.ndarray | None = None
    finished: bool = False
    image_path: str | None = None        # where precomputed features are found


def _pad_pow2(n, lo=256):
    """Coarse 4x-step padding of the local-map block."""
    c = lo
    while c < n:
        c *= 4
    return c


class Tracker:
    def __init__(self, cfg: TrackingConfig, camera: cam_ops.CameraParams, slam_map: SlamMap,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.cam = camera
        self.map = slam_map
        self.state = TrackState.NOT_INITIALIZED
        h, w = camera.height, camera.width

        def ext_cfg(n_features):
            return ExtractorConfig(
                n_features=n_features, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
                detect_th=cfg.detect_th, detector=cfg.detector, descriptor=cfg.descriptor)

        # the init extraction takes 2x features (reference Tracking.h:239)
        self.ext_cfg, self.ext_cfg_init = ext_cfg(cfg.n_features), ext_cfg(2 * cfg.n_features)
        # precomputed features (r2d2_128) are loaded per frame, not extracted
        self.precomputed = cfg.detector == "precomputed"
        self.extractor = self.extractor_init = None
        if not self.precomputed:
            self.extractor = make_extractor(self.ext_cfg, h, w).to(self.device)
            self.extractor_init = make_extractor(self.ext_cfg_init, h, w).to(self.device)
        b = [float(v) for v in cam_ops.undistorted_bounds(camera)]
        self.bounds_lo = np.array([b[0], b[2]], np.float32)
        self.bounds_hi = np.array([b[1], b[3]], np.float32)
        self._bounds_d = (torch.from_numpy(self.bounds_lo).to(self.device),
                          torch.from_numpy(self.bounds_hi).to(self.device))
        self.intrinsics = tuple(float(v) for v in (camera.fx, camera.fy, camera.cx, camera.cy))
        self._k = camera.k_matrix
        self.velocity = None          # T_cur_last
        self._fast_state = None
        # the last dispatched fused step's device outputs (carry, pose and
        # the pose before it), chained to the next dispatch
        self._chain = None
        # pipelined tracking: frames dispatched and not yet retired
        self.pipeline_depth = 0
        self._inflight: deque = deque()
        self._draining = False
        self._fs_built_fid = -(10 ** 9)
        self._weak_streak = 0
        self.last: FrameData | None = None
        self.init_ref: FrameData | None = None
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self.last_reloc_frame_id: int = -(10 ** 9)
        self.frame_id = 0
        self.n_inliers = 0
        self._n_map_inliers = 0       # map-point inliers of the last pose LM
        # localization mode (reference ActivateLocalizationMode, System.h:88;
        # onlyTracking / mbVO in Tracking::Track :184-278)
        self.only_tracking = False
        self.mb_vo = False
        self.trajectory: list = []    # per frame (ts, T_cur_ref, ref_kf uid, lost)
        self.on_new_keyframe = None   # callback(kf_id) -> local mapping
        self.on_keyframe_feats = None  # callback(kf_id, DeviceFeats)
        self.on_reset = None          # callback() after a map reset
        self.kf_dev = None            # keyframe -> its feature tensors
        self.database = None          # KeyFrameDatabase (relocalization)
        # the System's hooks into mapping: c1b's idle probe, the interrupt
        # of a running solve, "not mid-event in the sparse phase", and the
        # fresh-event token (check returns it, clear(token) clears it only
        # if no newer event has landed since)
        self.mapping_idle = lambda: True
        self.interrupt_mapping = lambda: None
        self.snapshot_safe = lambda: True
        self.map_fresh_check = lambda: 0
        self.map_fresh_clear = lambda token: None
        self.map_lock = threading.RLock()
        # the first initialization's reference frame, per-frame baseline,
        # second keyframe's centre and frame id, and trajectory length,
        # until the frame after it is tracked
        self._init_motion = None
        self.stats = dict(tracked_frames=0, lost_frames=0, resets=0, relocalizations=0,
                          reinitializations=0)

    def _to_dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _image(self, img):
        """(H, W) image -> uint8 tensor on the device."""
        if isinstance(img, torch.Tensor):
            return img.to(self.device)
        return self._to_dev(image_uint8(img))

    # ------------------------------------------------------------ frontend
    def _extract(self, img, init: bool, image_path: str | None = None) -> DeviceFeats:
        with perfcount.span("track.extract"):
            if self.precomputed:
                # r2d2_128-style offline features, read from the files
                # beside the image (reference src/Feature_r2d2_128.cpp:21-54)
                # on the host and uploaded once
                if image_path is None:
                    raise ValueError("precomputed features need the image path (pass it to "
                                     "process_frame / track_monocular)")
                cfg = self.ext_cfg_init if init else self.ext_cfg
                feats = {k: self._to_dev(v) for k, v in load_precomputed_features(
                    image_path, cfg.capacity, cfg.desc_dim).items()}
            else:
                ext = self.extractor_init if init else self.extractor
                feats = ext(self._image(img).to(torch.float32))
            feats["uv_und"] = cam_ops.undistort_points(self.cam, feats["xy"]).to(torch.float32)
        return DeviceFeats(feats)

    def _attach_depth(self, feats: DeviceFeats, depth_img: np.ndarray):
        """RGB-D: the depth map (on the host) sampled at the rounded raw
        keypoint pixels, and the virtual right coordinate u_right = u_und -
        bf / d (reference Frame::ComputeStereoFromRGBD, src/Frame.cc:648-670).
        Fetches the frame's small fields to the host (one sync)."""
        xy = feats["xy"]
        u = np.clip(np.rint(xy[:, 0]).astype(np.int64), 0, depth_img.shape[1] - 1)
        v = np.clip(np.rint(xy[:, 1]).astype(np.int64), 0, depth_img.shape[0] - 1)
        d = depth_img[v, u].astype(np.float32)
        d = np.where(feats["valid"] & (d > 0), d, -1.0).astype(np.float32)
        feats["depth"] = d
        with np.errstate(divide="ignore", invalid="ignore"):
            ur = feats["uv_und"][:, 0] - float(self.cfg.bf) / d
        feats["u_right"] = np.where(d > 0, ur, -1.0).astype(np.float32)

    def _attach_stereo(self, feats: DeviceFeats, img_left, img_right):
        """Stereo: the right image through the tracker's extractor (K1 a
        second time on the card), its keypoints matched to the left ones
        along rows and refined to sub-pixel disparity
        (frame_ops.match_stereo_rows_subpix; reference Frame stereo ctor,
        src/Frame.cc:60-95, ComputeStereoMatches :566-620). As in the JAX
        package the right extraction and the SAD windows take the images
        as given (the left extraction takes the uint8 copy). Rectified
        input: rows are matched on raw pixels, disparity in (0, fx)
        (min depth = the baseline)."""
        img_l = torch.as_tensor(img_left).to(self.device, torch.float32)
        img_r = torch.as_tensor(img_right).to(self.device, torch.float32)
        right = self.extractor(img_r)
        keys = ("desc_bits", "xy", "size", "valid")
        res = frame_ops.match_stereo_rows_subpix(
            img_l, img_r, *(feats.dev(k) for k in keys), *(right[k] for k in keys),
            self.cfg.match_th, 0.0, self.intrinsics[0])
        disp, ok = _host(res["disparity"]), _host(res["valid"])
        ok = ok & (disp > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            d = float(self.cfg.bf) / disp
        feats["depth"] = np.where(ok, d, -1.0).astype(np.float32)
        feats["u_right"] = np.where(ok, feats["xy"][:, 0] - disp, -1.0).astype(np.float32)

    def _unproject_depth(self, frame: FrameData, slots: np.ndarray, t_cw: np.ndarray):
        """World positions of keypoints from sensor depth (reference
        Frame::UnprojectStereo, src/Frame.cc:671-687)."""
        z = frame.feats["depth"][slots]
        uv = frame.feats["uv_und"][slots]
        fx, fy, cx, cy = self.intrinsics
        x = (uv[:, 0] - cx) * z / fx
        y = (uv[:, 1] - cy) * z / fy
        pc = np.stack([x, y, z], -1).astype(np.float32)
        r = t_cw[:3, :3]
        return pc @ r + (-r.T @ t_cw[:3, 3])  # pc @ Rwc.T + centre

    # ------------------------------------------------------------ main API
    def _fused_step_applies(self) -> bool:
        """A tracked frame runs the fused step (its extraction inside it):
        monocular frames out of localization mode, not precomputed
        features (the fused step cannot read files). RGB-D, stereo,
        localization-mode and precomputed frames take the staged path, as
        in the JAX package."""
        return (self.state == TrackState.OK and not self.precomputed
                and self.cfg.sensor == "monocular" and not self.only_tracking)

    def process_frame(self, img, ts: float, image_path: str | None = None,
                      depth: np.ndarray | None = None, img_right=None):
        """Track one frame. depth: an RGB-D frame's depth map in metres
        (host array); img_right: a stereo frame's rectified right image."""
        fid = self.frame_id
        self.frame_id += 1
        defer_extract = self._fused_step_applies()
        if self.pipeline_depth > 0 and defer_extract and not self._draining:
            # pipelined: dispatch this frame, retire the one that fell out
            # of the window
            rec = self._fast_dispatch(FrameData(fid, ts, None), img)
            if rec is not None:
                self._inflight.append(rec)
                while len(self._inflight) > self.pipeline_depth:
                    rec0 = self._inflight.popleft()
                    if not self._fast_retire(rec0, pipelined=True):
                        self._handle_fast_failure(rec0["frame"])
                        break
                return self.state
            # no usable chain or snapshot: the sequential path
        self.flush_pipeline()
        mono = self.cfg.sensor == "monocular"
        # the 2x init extraction serves the monocular initialization only
        init = self.state == TrackState.NOT_INITIALIZED and mono
        feats = None if self._fused_step_applies() else self._extract(
            img, init=init, image_path=image_path)
        frame = FrameData(fid, ts, feats, image_path=image_path)
        if depth is not None:
            self._attach_depth(feats, depth)
        elif img_right is not None:
            self._attach_stereo(feats, img, img_right)
        self._run_state_machine(frame, img)
        return self.state

    def _run_state_machine(self, frame: FrameData, img=None):
        """Per-frame state transitions (reference Track(), Tracking.cc:154-388)."""
        with perfcount.span("track.staged", frame.frame_id):
            if self.state == TrackState.NOT_INITIALIZED:
                if self.cfg.sensor == "monocular":
                    self._monocular_initialization(frame)
                else:
                    self._stereo_initialization(frame)
            elif self.state == TrackState.OK:
                if not self._track(frame, img):
                    self.state = TrackState.LOST
                    self.stats["lost_frames"] += 1
                    # reference: reset the whole system if lost early (:355-363)
                    if not self.only_tracking and self.map.n_keyframes() <= 5:
                        self._reset()
            elif self._relocalization(frame):
                self.state = TrackState.OK
                self.stats["relocalizations"] += 1
                self.last_reloc_frame_id = frame.frame_id
                self.mb_vo = False
                self.velocity = None
                self.last = frame
            else:
                self.stats["lost_frames"] += 1
            self._finish_frame(frame)

    def _finish_frame(self, frame: FrameData):
        """Record the frame's trajectory entry (once)."""
        if frame.finished or frame.pose is None or self.ref_kf < 0:
            return
        t_cr = frame.pose @ np.linalg.inv(self.map.kf_pose[self.ref_kf])
        self.trajectory.append((frame.ts, t_cr.copy(), int(self.map.kf_uid[self.ref_kf]),
                                self.state != TrackState.OK))
        self.stats["tracked_frames"] += 1
        frame.finished = True

    # ---------------------------------------------------------- pipeline
    def flush_pipeline(self):
        """Retire every in-flight frame, oldest first; a failure replays the
        rest through the state machine."""
        while self._inflight:
            rec = self._inflight.popleft()
            if not self._fast_retire(rec, pipelined=True):
                self._handle_fast_failure(rec["frame"])
                break

    def _handle_fast_failure(self, frame: FrameData):
        """A retired frame failed its speculative fused step: replay it and
        its (now stale) successors through the sequential state machine in
        order, with a fresh chain and a snapshot refresh through the gated
        path. The weak-frame streak is kept, so the budget of 3 weak frames
        holds across replays."""
        self._chain = None
        if self._fast_state is not None:
            self._fast_state["rev"] = -(10 ** 9)
        perfcount.bump("fast_failures")
        pending = [frame] + [rec["frame"] for rec in self._inflight]
        self._inflight.clear()
        self._draining = True
        try:
            for f in pending:
                f.pose = None
                f.matches = None
                self._run_state_machine(f, None)
        finally:
            self._draining = False

    def _reset(self):
        self._clear_map()
        self.stats["resets"] += 1

    def _clear_map(self):
        m = self.map
        with self.map_lock:
            m.__init__(m.max_kf, m.max_pt, m.n_feat, m.desc_dim, m.desc_dtype, m.device)
            self.state = TrackState.NOT_INITIALIZED
            self.velocity = None
            self.last = None
            self.init_ref = None
            self.ref_kf = -1
            self._fast_state = None
            self._chain = None
            self._init_motion = None
            if self.on_reset is not None:
                self.on_reset()

    # ---------------------------------------------------- initialization
    def _monocular_initialization(self, frame: FrameData):
        cfg = self.cfg
        n_valid = int(frame.feats["valid"].sum())
        if self.init_ref is None:
            if n_valid > 100:  # reference Tracking.cc:446-459
                self.init_ref = frame
            return
        if n_valid <= 100:
            self.init_ref = None
            return
        res = self._match_for_initialization(self.init_ref, frame)
        if int(res["valid"].sum()) < cfg.min_init_matches:
            self.init_ref = None  # reference Tracking.cc:469-476
            return
        init = self._two_view(self.init_ref, frame, res)
        if not bool(init["success"]):
            return
        self._create_initial_map(self.init_ref, frame, res, init, check_motion=True)

    def _match_for_initialization(self, ref: FrameData, frame: FrameData):
        keys = ("uv_und", "desc_bits", "octave", "angle", "valid")
        res = frame_ops.match_for_initialization(
            *(ref.feats.dev(k) for k in keys), *(frame.feats.dev(k) for k in keys),
            self.cfg.init_window, self.cfg.match_th, self.cfg.init_ratio)
        return {k: _host(v) for k, v in res.items()}

    def _two_view(self, ref: FrameData, frame: FrameData, res):
        uv2 = frame.feats["uv_und"][res["idx"]]
        init = initializer.initialize_two_view(
            self._to_dev(ref.feats["uv_und"]), self._to_dev(uv2.astype(np.float32)),
            self._to_dev(res["valid"]), self._k, self.cfg.seed)
        return {k: _host(v) for k, v in init.items()}

    def _rebuild_ambiguous_initialization(self, frame: FrameData, img) -> bool:
        """Called once, on the first frame tracked after the first
        initialization. A two-view map from a baseline near the parallax
        gate (1 degree) can be bent so that a rotation explains the next
        frames' image motion about as well as the true translation (the
        rotation-translation ambiguity of a small baseline): the pose LM
        then tracks them with almost no translation, the keyframes minted
        there add little the next BA can use, and the map can stay in that
        valley until tracking is lost. When this frame moved less than
        REINIT_MIN_MOTION of what the initial pair's per-frame motion
        predicts, the map is rebuilt by the two-view initialization from
        the same reference frame and this frame (extracted again with the
        init extractor), whose baseline is wider. Returns True when the map
        was rebuilt; the JAX package has no such step (ROADMAP.md section
        3)."""
        ref, step, centre, fid, n_traj = self._init_motion
        self._init_motion = None
        moved = float(np.linalg.norm(_centre(frame.pose) - centre))
        if moved >= REINIT_MIN_MOTION * step * (frame.frame_id - fid) or img is None:
            return False
        wide = FrameData(frame.frame_id, frame.ts,
                         self._extract(img, init=True, image_path=frame.image_path))
        res = self._match_for_initialization(ref, wide)
        if int(res["valid"].sum()) < self.cfg.min_init_matches:
            return False
        init = self._two_view(ref, wide, res)
        if not bool(init["success"]) or int((res["valid"] & init["good"]).sum()) \
                < self.cfg.min_init_tracked:
            return False
        # the initialization frame's trajectory entry refers to the map
        # being dropped
        self.stats["tracked_frames"] -= len(self.trajectory) - n_traj
        del self.trajectory[n_traj:]
        self._clear_map()
        self.stats["reinitializations"] += 1
        frame.feats = wide.feats
        self._create_initial_map(ref, frame, res, init)
        return True

    def _create_initial_map(self, ref: FrameData, frame: FrameData, match, init,
                            check_motion: bool = False):
        """Reference CreateInitialMapMonocular (Tracking.cc:510-599).
        check_motion: hold the next tracked frame's motion against this
        pair's (``_rebuild_ambiguous_initialization``)."""
        cfg = self.cfg
        good = match["valid"] & init["good"]
        if int(good.sum()) < cfg.min_init_tracked:
            return
        t1 = np.eye(4, dtype=np.float32)
        t21 = init["t21"].astype(np.float32)
        slots1 = np.nonzero(good)[0]
        slots2 = match["idx"][slots1]
        pts3d = init["pts3d"][slots1].astype(np.float32)
        matches1 = np.full(self.map.n_feat, -1, np.int32)
        matches2 = np.full(self.map.n_feat, -1, np.int32)

        # the init extraction has 2x the keyframe's slots: keep every
        # matched keypoint, fill the rest with the strongest unmatched ones
        def compact(feats, priority_slots):
            n_out = self.map.n_feat
            cap = len(feats["valid"])
            pri = np.zeros(cap, bool)
            pri[priority_slots] = True
            rest = np.nonzero(feats["valid"] & ~pri)[0]
            rest = rest[np.argsort(-feats["resp"][rest], kind="stable")]
            order = np.concatenate([priority_slots, rest])[:n_out]
            out = {k: v[order] for k, v in feats.items()}
            if len(order) < n_out:
                pad = n_out - len(order)
                for k, v in out.items():
                    out[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                out["valid"][len(order):] = False
            slot_map = np.full(cap, -1, np.int64)
            slot_map[order] = np.arange(len(order))
            return out, slot_map

        f1, map1 = compact(ref.feats, slots1)
        f2, map2 = compact(frame.feats, slots2)
        slots1 = map1[slots1]
        slots2 = map2[slots2]
        kf1 = self.map.add_keyframe(t1, ref.ts, ref.frame_id, f1, matches1)
        kf2 = self.map.add_keyframe(t21, frame.ts, frame.frame_id, f2, matches2)
        ids = self.map.add_points(pts3d, f1["desc_bits"][slots1], kf1, f1["size"][slots1])
        self.map.kf_matches[kf1][slots1] = ids
        self.map.kf_matches[kf2][slots2] = ids
        self.map.update_point_stats(ids)

        # BA on the initial two-keyframe map (reference: 20 iterations)
        from .local_mapping import run_bundle_adjustment

        run_bundle_adjustment(self.map, self.intrinsics, free_kfs=[kf2], fixed_kfs=[kf1],
                              pt_ids=ids, n_iters_a=10, n_iters_b=10, device=self.device)

        # scale normalization: median scene depth -> 1 (Tracking.cc:551-575)
        mm1 = self.map.kf_matches[kf1]
        pc = self.map.pt_pos[mm1[mm1 >= 0]] @ self.map.kf_pose[kf1][:3, :3].T \
            + self.map.kf_pose[kf1][:3, 3]
        median_depth = float(np.median(pc[:, 2]))
        n_tracked = int((self.map.kf_matches[kf2] >= 0).sum())
        if median_depth <= 0 or n_tracked < cfg.min_init_tracked:
            self._reset()
            return
        inv_md = 1.0 / median_depth
        for kf in (kf1, kf2):
            self.map.kf_pose[kf][:3, 3] *= inv_md
        new_pts = np.asarray(ids)
        new_pts = new_pts[self.map.pt_valid[new_pts]]
        self.map.pt_pos[new_pts] *= inv_md
        self.map.update_point_stats(new_pts)

        frame.pose = self.map.kf_pose[kf2].copy()
        frame.matches = self.map.kf_matches[kf2].copy()
        self.ref_kf = kf2
        self.last_kf_frame_id = frame.frame_id
        self.last = frame
        self.velocity = None
        self.state = TrackState.OK
        self.init_ref = None
        if check_motion:
            c1, c2 = _centre(self.map.kf_pose[kf1]), _centre(self.map.kf_pose[kf2])
            step = float(np.linalg.norm(c2 - c1)) / max(frame.frame_id - ref.frame_id, 1)
            self._init_motion = (ref, step, c2, frame.frame_id, len(self.trajectory))
        if self.on_new_keyframe:
            self.on_new_keyframe(kf1)
            self.on_new_keyframe(kf2)

    def _stereo_initialization(self, frame: FrameData):
        """Instant map from sensor depth (reference
        Tracking::StereoInitialization, src/Tracking.cc:390-437): more than
        500 keypoints, at least 100 of them with depth; identity pose, one
        keyframe, a map point per keypoint with depth."""
        depth = frame.feats.get("depth")
        if depth is None or int(frame.feats["valid"].sum()) <= 500:  # minKeypointsStereo
            return
        pose = np.eye(4, dtype=np.float32)
        frame.pose = pose
        m = self.map
        kf = m.add_keyframe(pose, frame.ts, frame.frame_id, frame.feats,
                            np.full(m.n_feat, -1, np.int32))
        slots = np.nonzero(frame.feats["valid"] & (depth > 0))[0]
        if len(slots) < 100:
            m.remove_keyframe(kf)
            frame.pose = None
            return
        ids = m.add_points(self._unproject_depth(frame, slots, pose),
                           frame.feats["desc_bits"][slots], kf, frame.feats["size"][slots])
        m.kf_matches[kf][slots] = ids
        m.update_point_stats(ids)
        frame.matches = m.kf_matches[kf].copy()
        self.ref_kf = kf
        self.last_kf_frame_id = frame.frame_id
        self.last = frame
        self.velocity = None
        self.state = TrackState.OK
        if self.on_new_keyframe:
            self.on_new_keyframe(kf)

    # ------------------------------------------------------------ tracking
    def _resolve_stale_matches(self, matches):
        """Follow fusion replacement links and drop dead ids in place
        (reference CheckReplacedInLastFrame, src/Tracking.cc:601-617)."""
        m = self.map
        sel = np.nonzero(matches >= 0)[0]
        if len(sel) == 0:
            return
        ids = matches[sel]
        for _ in range(4):  # resolve replacement chains
            rep = m.pt_replaced[ids]
            step = rep >= 0
            if not step.any():
                break
            ids = np.where(step, rep, ids)
        matches[sel] = np.where(m.pt_valid[ids], ids, -1)

    def _track(self, frame: FrameData, img=None) -> bool:
        if self.last is not None and self.last.matches is not None:
            self._resolve_stale_matches(self.last.matches)
        if self.only_tracking:
            if not self._track_localization(frame):
                return False
        elif not self._track_mapping(frame, img):
            return False
        if self._init_motion is not None and self._rebuild_ambiguous_initialization(frame, img):
            return True
        # velocity update (reference Tracking.cc:340-350)
        if self.last is not None and self.last.pose is not None:
            self.velocity = frame.pose @ np.linalg.inv(self.last.pose)
        self.last = frame
        if not self.only_tracking and self._need_new_keyframe(frame):
            self._create_new_keyframe(frame)
        return True

    def _track_mapping(self, frame: FrameData, img) -> bool:
        """The tracked frame while mapping runs: the fused step where it
        applies, else the staged path."""
        cfg = self.cfg
        fast = self._try_fast_track(frame, img)
        if fast is not None and not fast and not self._draining and self.pipeline_depth == 0:
            return False  # sequential: the fused step's failure is authoritative
        ok = bool(fast)
        if not ok:
            # the fused step does not apply (the frame after initialization
            # carries the 2x init extraction; RGB-D and stereo frames) or its
            # speculative snapshot failed in a replay: the staged path,
            # motion -> ref-KF -> local map (reference Track() :293-316)
            if frame.feats is None:
                frame.feats = self._extract(img, init=False)
            frame.pose = None
            frame.matches = None
            if self.velocity is not None and frame.frame_id >= self.last_reloc_frame_id + 2:
                ok = self._track_motion_model(frame)
            if not ok:
                ok = self._track_reference_kf(frame)
            if ok:
                ok = self._track_local_map(frame)
                if (not ok and self.pipeline_depth > 0 and frame.pose is not None
                        and self.n_inliers >= max(cfg.kf_min_inliers + 3, 18)
                        and self._weak_streak < 3):
                    # the pipelined retire's hysteresis band (see _fast_retire)
                    self._weak_streak += 1
                    perfcount.bump("weak_frames")
                    ok = True
                elif ok:
                    self._weak_streak = 0
            perfcount.bump("staged_frames")
        return ok

    def _track_localization(self, frame: FrameData) -> bool:
        """Localization mode (reference Tracking.cc:210-296): mapping is
        off. Out of mb_vo, the motion model (the reference keyframe without
        a velocity), then the local map. In mb_vo (the map has drifted out
        of view) the motion model rides the last frame's depth points while
        relocalization is tried at every frame; a relocalization ends
        mb_vo."""
        if not self.mb_vo:
            if self.velocity is not None:
                ok = self._track_motion_model(frame)
            else:
                ok = self._track_reference_kf(frame)
        else:
            ok_mm = self.velocity is not None and self._track_motion_model(frame)
            mm_pose = frame.pose.copy() if ok_mm else None
            mm_matches = frame.matches.copy() if ok_mm else None
            ok_reloc = self._relocalization(frame)
            if ok_reloc:
                self.mb_vo = False
                self.last_reloc_frame_id = frame.frame_id
                self.stats["relocalizations"] += 1
            elif ok_mm:
                frame.pose, frame.matches = mm_pose, mm_matches
            ok = ok_reloc or ok_mm
        if ok and not self.mb_vo:
            ok = self._track_local_map(frame)
        return ok

    def _pose_optimize(self, frame: FrameData, matches: np.ndarray, init_pose):
        """matches: (N,) kp -> pt id. Returns (pose, inlier matches, n_inliers).
        The frame's visual-odometry points (localization mode) join the
        solve on slots without a map match; the map-point inliers are kept
        apart for the mb_vo decision (reference TrackWithMotionModel counts
        nmatchesMap, Tracking.cc:770-789)."""
        has = matches >= 0
        pts = self.map.pt_pos[np.where(has, matches, 0)]
        mask = has
        if frame.vo_pts3d is not None:
            use_vo = frame.vo_valid & ~has
            pts = np.where(use_vo[:, None], frame.vo_pts3d, pts).astype(np.float32)
            mask = has | use_vo
        with perfcount.span("track.pose_lm", frame.frame_id):
            t, inlier, n_in = pose_opt.pose_optimize(
                self._to_dev(init_pose.astype(np.float32)), self._to_dev(pts),
                frame.feats.dev("uv_und"), frame.feats.dev("inv_sigma2"),
                self._to_dev(mask & frame.feats["valid"]), *self.intrinsics)
        inlier = _host(inlier)
        if frame.vo_pts3d is not None:
            frame.vo_valid = frame.vo_valid & inlier
        self._n_map_inliers = int((inlier & has).sum())
        return _host(t), np.where(inlier, matches, -1).astype(np.int32), int(n_in)

    def _track_motion_model(self, frame: FrameData) -> bool:
        cfg = self.cfg
        last = self.last
        pred_pose = (self.velocity @ last.pose).astype(np.float32)
        has_pt = last.matches >= 0
        pts = self.map.pt_pos[np.where(has_pt, last.matches, 0)]
        # localization mode with depth: the last frame's map points joined
        # by its depth points (reference UpdateLastFrame's temporal points,
        # Tracking.cc:673-727)
        vo_mask = None
        if (self.only_tracking and cfg.sensor != "monocular" and "depth" in last.feats
                and last.pose is not None):
            vo_mask = ~has_pt & last.feats["valid"] & (last.feats["depth"] > 0)
            if vo_mask.any():
                slots = np.nonzero(vo_mask)[0]
                pts_vo = np.zeros_like(pts)
                pts_vo[slots] = self._unproject_depth(last, slots, last.pose)
                pts = np.where(vo_mask[:, None], pts_vo, pts)
                has_pt = has_pt | vo_mask
            else:
                vo_mask = None
        pc = pts @ pred_pose[:3, :3].T + pred_pose[:3, 3]
        z = pc[:, 2]
        fx, fy, cx, cy = self.intrinsics
        with np.errstate(divide="ignore", invalid="ignore"):
            u = fx * pc[:, 0] / z + cx
            v = fy * pc[:, 1] / z + cy
        uv_proj = np.stack([u, v], -1).astype(np.float32)
        proj_valid = (has_pt & (z > 0) & (u >= self.bounds_lo[0]) & (u < self.bounds_hi[0])
                      & (v >= self.bounds_lo[1]) & (v < self.bounds_hi[1]))
        uv_proj = np.where(np.isfinite(uv_proj), uv_proj, 0.0).astype(np.float32)
        res = frame_ops.match_frame_to_frame_2r(
            last.feats.dev("uv_und"), last.feats.dev("desc_bits"), last.feats.dev("size"),
            self._to_dev(has_pt), self._to_dev(uv_proj), self._to_dev(proj_valid),
            frame.feats.dev("uv_und"), frame.feats.dev("desc_bits"), frame.feats.dev("size"),
            frame.feats.dev("valid"), last.feats.dev("angle"), frame.feats.dev("angle"),
            float(cfg.motion_radius), cfg.match_th, cfg.min_motion_matches)
        res = {k: _host(v) for k, v in res.items()}
        if int(res["valid"].sum()) < cfg.min_motion_matches:
            return False
        matches = np.full(self.map.n_feat, -1, np.int32)
        src = np.nonzero(res["valid"])[0]
        matches[res["idx"][src]] = last.matches[src]
        if vo_mask is not None:
            src_vo = src[vo_mask[src]]
            if len(src_vo):
                frame.vo_pts3d = np.zeros((self.map.n_feat, 3), np.float32)
                frame.vo_valid = np.zeros(self.map.n_feat, bool)
                frame.vo_pts3d[res["idx"][src_vo]] = pts[src_vo]
                frame.vo_valid[res["idx"][src_vo]] = True
        pose, matches, n_in = self._pose_optimize(frame, matches, pred_pose)
        frame.pose = pose
        frame.matches = matches
        if self.only_tracking:
            # mb_vo: few map points matched (reference Tracking.cc:781-787)
            self.mb_vo = self._n_map_inliers < 10
            return n_in > 20
        return n_in >= cfg.min_track_inliers

    def _track_reference_kf(self, frame: FrameData) -> bool:
        cfg = self.cfg
        if self.ref_kf < 0:
            return False
        kf = self.ref_kf
        m = self.map
        res = frame_ops.match_descriptors_global(
            frame.feats.dev("desc_bits"), frame.feats.dev("valid"), frame.feats.dev("angle"),
            self._to_dev(m.kf_desc_bits[kf]),
            self._to_dev((m.kf_matches[kf] >= 0) & m.kf_feat_valid[kf]),
            self._to_dev(m.kf_angle[kf]), cfg.match_th, cfg.refkf_ratio)
        res = {k: _host(v) for k, v in res.items()}
        if int(res["valid"].sum()) < 15:  # reference needs >= 15 BoW matches
            return False
        matches = np.where(res["valid"], m.kf_matches[kf][res["idx"]], -1).astype(np.int32)
        init_pose = self.last.pose if self.last and self.last.pose is not None else m.kf_pose[kf]
        pose, matches, n_in = self._pose_optimize(frame, matches, init_pose)
        frame.pose = pose
        frame.matches = matches
        return n_in >= cfg.min_track_inliers

    def _local_map_ids(self, frame: FrameData):
        """Local keyframes + points (reference UpdateLocalKeyFrames /
        UpdateLocalPoints, Tracking.cc:1040-1144)."""
        matched = frame.matches[frame.matches >= 0]
        if len(matched) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        kfs = self.map.keyframe_ids()
        m_all = self.map.kf_matches[kfs]
        pt_mask = np.zeros(self.map.max_pt, bool)
        pt_mask[matched] = True
        counts = ((m_all >= 0) & pt_mask[np.maximum(m_all, 0)]).sum(axis=1)
        seen = counts > 0
        order = np.argsort(-counts[seen], kind="stable")
        k1 = kfs[seen][order][: self.cfg.max_local_kfs]
        local_kfs = k1.tolist()
        if len(k1):
            best = int(k1[0])
            cov, _ = self.map.covisible_keyframes(best, min_weight=15, max_n=10)
            extra = [int(kf) for kf in cov if kf not in set(local_kfs)]
            local_kfs.extend(extra[: max(self.cfg.max_local_kfs - len(local_kfs), 0)])
            self.ref_kf = best
        m_local = self.map.kf_matches[np.asarray(local_kfs, np.int64)]
        pts = np.unique(m_local[m_local >= 0])
        return np.asarray(local_kfs, np.int64), pts.astype(np.int64)

    def _track_local_map(self, frame: FrameData) -> bool:
        cfg = self.cfg
        _, local_pts = self._local_map_ids(frame)
        if len(local_pts) == 0:
            return False
        cand = local_pts
        bucket = _pad_pow2(len(cand), lo=min(cfg.local_pt_bucket, 256))
        idx = np.concatenate([cand, np.zeros(bucket - len(cand), np.int64)])
        already = np.zeros(self.map.max_pt, bool)
        already[frame.matches[frame.matches >= 0]] = True
        pad_valid = np.concatenate([~already[cand], np.zeros(bucket - len(cand), bool)])
        blk = self.map.mirror().gather(idx)
        res = frame_ops.project_and_match(
            *blk[:7], self._to_dev(pad_valid), self._to_dev(frame.pose), *self.intrinsics,
            *self._bounds_d, frame.feats.dev("uv_und"), frame.feats.dev("desc_bits"),
            frame.feats.dev("size"), frame.feats.dev("valid"),
            cfg.local_radius, cfg.match_th, cfg.local_ratio)
        res = {k: _host(v) for k, v in res.items()}
        self.map.pt_visible[idx[res["visible"]]] += 1
        matches = frame.matches.copy()
        src = np.nonzero(res["valid"])[0]
        tgt = res["idx"][src]
        free_slot = matches[tgt] < 0
        matches[tgt[free_slot]] = idx[src[free_slot]]
        pose, matches, n_in = self._pose_optimize(frame, matches, frame.pose)
        frame.pose = pose
        frame.matches = matches
        self.n_inliers = n_in
        self.map.pt_found[matches[matches >= 0]] += 1
        return n_in >= cfg.min_local_inliers

    # ----------------------------------------------------- fused fast path
    def _try_fast_track(self, frame: FrameData, img):
        """The tracked frame in one fused step, dispatched and retired at
        once. Returns True / False (the tracking outcome) or None when the
        fused step does not apply."""
        rec = self._fast_dispatch(frame, img)
        if rec is None:
            return None
        return self._fast_retire(rec, pipelined=False)

    def _fast_dispatch(self, frame: FrameData, img=None):
        """Issue the fused step for `frame` (extraction included when its
        features are not there yet) and start the copies of its small
        outputs to the host. Returns an in-flight record for _fast_retire,
        or None when the fused step does not apply (``_fused_step_applies``,
        or no features and no image). The device chain (the
        last dispatch's carry and its two last poses) lets a dispatch run
        before its predecessor has been retired: the constant-velocity
        prediction runs on the device (fast_track.predict_pose)."""
        cfg = self.cfg
        if not self._fused_step_applies() or not (
                isinstance(frame.feats, DeviceFeats) or (frame.feats is None and img is not None)):
            return None
        m = self.map
        fs_rebuilt = False
        chain = self._chain
        if chain is not None and chain["fid"] != frame.frame_id - 1:
            chain = None  # a slow or lost frame broke the chain
        if chain is None:
            # seed from the last retired frame's host truth
            last = self.last
            if (last is None or last.pose is None or last.matches is None
                    or not isinstance(last.feats, DeviceFeats)
                    # the post-init frame carries the 2x-capacity init extraction
                    or int(last.feats.dev("uv_und").shape[0]) != m.n_feat):
                return None
            chain = dict(fid=last.frame_id, carry=self._build_fast_carry(),
                         pose=self._to_dev(last.pose.astype(np.float32)), prev=None)
        fs = self._fast_state
        if fs is None or fs["rev"] != m.rev:
            # refresh the snapshot when the map changed, preferably at an
            # event boundary: mid-event the map is sparse (recent points
            # culled, the event's new points not yet folded)
            age = frame.frame_id - self._fs_built_fid
            if self.pipeline_depth > 0:
                # one eager rebuild right after an event's folds landed, and
                # rate-limited idle or decay rebuilds
                fresh = bool(self.map_fresh_check()) and self.snapshot_safe()
                need = fs is None or (age >= 2 and fresh) or (
                    age >= 3 and (self.mapping_idle() or (
                        self.snapshot_safe() and (self.n_inliers < 45 or age >= 10))))
            else:
                # sequential: rebuild whenever mapping is parked
                need = fs is None or self.mapping_idle()
            if need:
                fs = self._rebuild_snapshot(frame.frame_id)
                fs_rebuilt = True
                if fs is None:
                    return None
        if fs_rebuilt and self.last is not None and self.last.frame_id == chain["fid"]:
            # re-anchor the chain on the host's refined state
            chain = dict(fid=self.last.frame_id, carry=self._build_fast_carry(),
                         pose=self._to_dev(self.last.pose.astype(np.float32)), prev=None)
        reloc_ok = frame.frame_id >= self.last_reloc_frame_id + 2
        prev = chain["pose"]  # the pose before this frame's, for the next prediction
        if (self.pipeline_depth == 0 and self.last is not None and self.last.pose is not None
                and self.last.frame_id == chain["fid"]):
            # sequential: prediction and LM seed from the host poses, which
            # carry every mapping-side refinement
            use_motion = self.velocity is not None and reloc_ok
            pred = self.velocity @ self.last.pose if use_motion else self.last.pose
            pred = self._to_dev(pred.astype(np.float32))
            last_pose = self._to_dev(self.last.pose.astype(np.float32))
        elif chain["prev"] is not None and reloc_ok:
            # pipelined: the velocity of the two previous dispatches, on the
            # device (the host has not seen those poses yet)
            use_motion = True
            pred = fast_track.predict_pose(chain["pose"], chain["prev"])
            last_pose = chain["pose"]
        elif (self.velocity is not None and reloc_ok and self.last is not None
              and self.last.frame_id == chain["fid"]):
            # pipelined, the chain reseeded from the last retired frame,
            # `gap` frames back (pipeline_depth + 1 when steady): the host's
            # velocity applied over the gap, and the frame before this one
            # predicted alike as the LM seed of the reference-keyframe
            # fallback and the next prediction's previous pose. The JAX
            # package applies one step and keeps the retired pose as the
            # previous one, so when keyframes mint at every retire (each mint
            # breaks the chain) every frame is predicted two frames behind,
            # and the pose LM can settle in the rotation-translation valley
            # of a far, flat scene next to that seed. Rotations are kept on
            # SO(3) as the device chain's are (fast_track.predict_pose).
            use_motion = True
            gap = frame.frame_id - self.last.frame_id
            vel = self.velocity.astype(np.float64)
            before = np.linalg.matrix_power(vel, gap - 1) @ self.last.pose.astype(np.float64)
            pred = fast_track.on_se3(self._to_dev((vel @ before).astype(np.float32)))
            if gap > 1:
                prev = fast_track.on_se3(self._to_dev(before.astype(np.float32)))
            last_pose = prev
        else:
            use_motion = False
            pred = last_pose = chain["pose"]
        carry = chain["carry"]
        fx, fy, cx, cy = self.intrinsics
        track_args = dict(
            **{f"last_{k}": v for k, v in carry.items()}, **fs["ref"], **fs["block"],
            pred_pose=pred, last_pose=last_pose, use_motion=use_motion,
            bounds_lo=self._bounds_d[0], bounds_hi=self._bounds_d[1],
            fx=fx, fy=fy, cx=cx, cy=cy, motion_radius=float(cfg.motion_radius),
            match_th=float(cfg.match_th), min_motion_matches=cfg.min_motion_matches,
            refkf_ratio=float(cfg.refkf_ratio), local_radius=float(cfg.local_radius),
            local_ratio=float(cfg.local_ratio), min_track_inliers=cfg.min_track_inliers)
        if frame.feats is None:
            feats_d, out = fast_track.fused_extract_track(
                self._image(img), self.cam, self.extractor, **track_args)
            frame.feats = DeviceFeats(feats_d)
        else:
            # a replayed frame keeps the features of its first dispatch
            f = frame.feats
            out = fast_track.fused_track_step(
                *(f.dev(k) for k in ("uv_und", "desc_bits", "size", "angle", "valid",
                                     "inv_sigma2")), **track_args)
        feats = frame.feats
        pose_d, pt_d, n_in_d, vis_d, ok1_d, _, pos_d = out
        self._chain = dict(
            fid=frame.frame_id,
            carry=dict(uv=feats.dev("uv_und"), bits=feats.dev("desc_bits"),
                       size=feats.dev("size"), angle=feats.dev("angle"),
                       match_pt=pt_d, match_pos=pos_d),
            pose=pose_d, prev=prev)
        perfcount.bump("track_dispatches")
        return dict(frame=frame, ready=streams.Ready((pose_d, pt_d, n_in_d, vis_d, ok1_d)),
                    blk_ids_np=fs["blk_ids_np"], blk_valid_np=fs["blk_valid_np"])

    def _rebuild_snapshot(self, frame_id: int):
        """Build the device snapshot under the map lock and clear the
        fresh-event token it saw (a newer event's token stays set, so its
        points enter the next snapshot)."""
        with perfcount.span("track.snapshot", frame_id):
            with self.map_lock:
                token = self.map_fresh_check()
                fs = self._build_fast_state()
            self._fast_state = fs
            self._fs_built_fid = frame_id
            self.map_fresh_clear(token)
        perfcount.bump("fs_rebuilds")
        return fs

    def _fast_retire(self, rec, pipelined: bool) -> bool:
        """Consume a dispatched frame's results: host bookkeeping and (when
        pipelined) the velocity, trajectory and keyframe decision that the
        sequential path performs in _track."""
        with perfcount.span("track.retire", rec["frame"].frame_id):
            cfg = self.cfg
            m = self.map
            frame = rec["frame"]
            if pipelined:
                self._init_motion = None  # checked on the sequential path only
            with perfcount.span("track.retire_wait"):
                pose_np, pt_np, n_in, vis_np, ok1 = rec["ready"].host()
            if not bool(ok1):
                # both branches failed: tracking lost (reference Track() :293-316);
                # a restart reseeds the chain from host truth
                self._chain = None
                return False
            frame.pose = np.array(pose_np, np.float32)
            matches = np.array(pt_np, np.int32)
            # resolve points merged or culled since the snapshot before counting
            self._resolve_stale_matches(matches)
            frame.matches = matches
            n_in = int(n_in)
            self.n_inliers = n_in
            m.pt_visible[rec["blk_ids_np"][vis_np & rec["blk_valid_np"]]] += 1
            m.pt_found[matches[matches >= 0]] += 1
            # the reference-keyframe scan is (K, N): every other frame suffices
            # when pipelined
            if not pipelined or frame.frame_id % 2 == 0:
                self._update_ref_kf_from_matches(matches)
            # hysteresis band while the tracker runs pipelined (a replay
            # included): a frame with weak_floor <= inliers < 30 keeps tracking,
            # three weak frames in a row fail as the reference's TrackLocalMap
            # does (src/Tracking.cc:829-836)
            weak_floor = max(cfg.kf_min_inliers + 3, 18)
            ok = n_in >= cfg.min_local_inliers
            if (not ok and (pipelined or self.pipeline_depth > 0) and n_in >= weak_floor
                    and self._weak_streak < 3):
                self._weak_streak += 1
                perfcount.bump("weak_frames")
                ok = True
            elif ok:
                self._weak_streak = 0
            if not ok:
                self._chain = None
            elif pipelined:
                # the tail of _track, at retire time
                if self.last is not None and self.last.pose is not None:
                    self.velocity = frame.pose @ np.linalg.inv(self.last.pose)
                self.last = frame
                self._finish_frame(frame)
                if self._need_new_keyframe(frame):
                    self._create_new_keyframe(frame)
            return ok

    def _build_fast_state(self):
        """The local-map block and the reference-keyframe snapshot on the
        device, valid until the next map mutation (map.rev bump)."""
        m = self.map
        if self.last is None or self.last.matches is None or self.ref_kf < 0:
            return None
        _, local_pts = self._local_map_ids(self.last)
        if len(local_pts) == 0:
            return None
        cap = _pad_pow2(len(local_pts), lo=self.cfg.local_pt_bucket)
        idx = np.full(cap, -1, np.int64)
        idx[: len(local_pts)] = local_pts
        blk_valid = np.zeros(cap, bool)
        blk_valid[: len(local_pts)] = m.pt_valid[local_pts]
        # the block rows are gathered on the device from the point mirror
        ids_dev = self._to_dev(idx.astype(np.int32))
        rows = m.mirror().gather(ids_dev)
        block = dict(zip(("blk_pos", "blk_normal", "blk_min_dist", "blk_max_dist",
                          "blk_ref_size", "blk_ref_dist", "blk_bits", "blk_valid"), rows))
        block["blk_ids"] = ids_dev
        kf = self.ref_kf
        ref_match = m.kf_matches[kf].astype(np.int32)
        ref_has = (ref_match >= 0) & m.kf_feat_valid[kf]
        if self.kf_dev is not None:
            ent = self.kf_dev(kf)
            ref_bits, ref_angle = ent["bits"], ent["angle"]
        else:
            ref_bits, ref_angle = self._to_dev(m.kf_desc_bits[kf]), self._to_dev(m.kf_angle[kf])
        ref = dict(ref_bits=ref_bits, ref_angle=ref_angle, ref_has=self._to_dev(ref_has),
                   ref_match_pt=self._to_dev(np.where(ref_has, ref_match, -1).astype(np.int32)),
                   ref_match_pos=self._to_dev(m.pt_pos[np.maximum(ref_match, 0)]))
        return dict(rev=m.rev, ref_kf=kf, block=block, ref=ref, blk_ids_np=idx,
                    blk_valid_np=blk_valid)

    def _build_fast_carry(self):
        """The motion-model branch's carry, rebuilt from host truth."""
        last = self.last
        m = self.map
        mp = last.matches
        ok = (mp >= 0) & m.pt_valid[np.maximum(mp, 0)]
        return dict(uv=last.feats.dev("uv_und"), bits=last.feats.dev("desc_bits"),
                    size=last.feats.dev("size"), angle=last.feats.dev("angle"),
                    match_pt=self._to_dev(np.where(ok, mp, -1).astype(np.int32)),
                    match_pos=self._to_dev(m.pt_pos[np.maximum(mp, 0)]))

    def _update_ref_kf_from_matches(self, matches):
        """The reference keyframe: the keyframe sharing most of the frame's
        points (UpdateLocalKeyFrames, reference Tracking.cc:1135-1141)."""
        matched = matches[matches >= 0]
        if len(matched) == 0:
            return
        m = self.map
        kfs = m.keyframe_ids()
        pt_mask = np.zeros(m.max_pt, bool)
        pt_mask[matched] = True
        m_all = m.kf_matches[kfs]
        counts = ((m_all >= 0) & pt_mask[np.maximum(m_all, 0)]).sum(axis=1)
        if counts.max(initial=0) > 0:
            self.ref_kf = int(kfs[np.argmax(counts)])

    # ----------------------------------------------------- relocalization
    def _relocalization(self, frame: FrameData) -> bool:
        """Reference Relocalization (Tracking.cc:1146-1309): BoW candidates
        -> per-candidate descriptor search (>= 15 matches) -> RANSAC-EPnP ->
        pose LM; success needs >= 50 inliers after the local map. Holds the
        map lock (it reads broad map state and is rare)."""
        if self.database is None:
            return False
        with perfcount.span("track.reloc", frame.frame_id), self.map_lock:
            return self._relocalization_impl(frame)

    def _relocalization_impl(self, frame: FrameData) -> bool:
        m = self.map
        cfg = self.cfg
        feats = frame.feats
        cands = [int(k) for k in self.database.detect_relocalization_candidates(
            feats.dev("desc_bits"), feats.dev("valid"), m) if m.kf_valid[int(k)]]
        cands = cands[:RELOC_MAX_CANDIDATES]
        if not cands:
            return False
        # one K2 search per candidate, on its descriptors prepared once and
        # cached with its features (LocalMapper.kf_dev)
        has = np.stack([(m.kf_matches[kf] >= 0) & m.kf_feat_valid[kf] for kf in cands])
        if self.kf_dev is not None:
            rows = [self.kf_dev(kf) for kf in cands]
            bits, angle, words = ([r[k] for r in rows] for k in ("bits", "angle", "words"))
        else:
            bits = [self._to_dev(m.kf_desc_bits[kf]) for kf in cands]
            angle = [self._to_dev(m.kf_angle[kf]) for kf in cands]
            words = None
        res = frame_ops.match_descriptors_to_many(
            feats.dev("desc_bits"), feats.dev("valid"), feats.dev("angle"), bits,
            list(self._to_dev(has)), angle, cfg.match_th, 0.75, words)
        res = {k: _host(v) for k, v in res.items()}
        nq = res["valid"].shape[1]
        pts_c = np.zeros((len(cands), nq, 3), np.float32)
        val_c = np.zeros((len(cands), nq), bool)
        match_pt = np.full((len(cands), nq), -1, np.int32)
        enough = np.zeros(len(cands), bool)
        for i, kf in enumerate(cands):
            sl = np.nonzero(res["valid"][i])[0]
            if len(sl) < RELOC_MIN_MATCHES:
                continue
            enough[i] = True
            ids = m.kf_matches[kf][res["idx"][i][sl]]
            pts_c[i, sl] = m.pt_pos[ids]
            val_c[i, sl] = True
            match_pt[i, sl] = ids
        if not enough.any():
            return False
        # one batched RANSAC-EPnP over the candidates with enough matches
        # (the reference interleaves PnPsolver::iterate(5) across them)
        sel = np.nonzero(enough)[0]
        c = len(sel)
        sigma2 = 1.0 / torch.clamp(feats.dev("inv_sigma2"), min=1e-9)
        out = pnp.pnp_ransac_many(
            self._to_dev(pts_c[sel]), feats.dev("uv_und").expand(c, -1, -1),
            sigma2.expand(c, -1), self._to_dev(val_c[sel]), *self.intrinsics, cfg.seed)
        out = {k: _host(v) for k, v in out.items()}
        for j, i in enumerate(sel):
            kf = cands[i]
            if int(out["n_inliers"][j]) < RELOC_MIN_PNP:
                continue
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = out["r"][j]
            pose[:3, 3] = out["t"][j]
            inl = out["inliers"][j] & val_c[i]
            matches = np.full(m.n_feat, -1, np.int32)
            k = min(nq, m.n_feat)
            matches[:k] = np.where(inl, match_pt[i], -1)[:k]
            pose, matches, n_in = self._pose_optimize(frame, matches, pose)
            if n_in < RELOC_MIN_PNP:
                continue
            # coarse, then narrow projection add-match rounds (reference
            # Tracking.cc:1256-1288)
            if n_in < RELOC_GOOD:
                matches2, n_add = self._reloc_add_matches(frame, kf, matches, pose, 10.0)
                if n_add + n_in >= RELOC_GOOD:
                    pose, matches, n_in = self._pose_optimize(frame, matches2, pose)
                    if 30 < n_in < RELOC_GOOD:
                        matches2, n_add = self._reloc_add_matches(frame, kf, matches, pose, 3.0)
                        if n_in + n_add >= RELOC_GOOD:
                            pose, matches, n_in = self._pose_optimize(frame, matches2, pose)
            if n_in < RELOC_MIN_PNP:
                continue
            frame.pose = pose
            frame.matches = matches
            self.ref_kf = kf
            if self._track_local_map(frame) and self.n_inliers >= RELOC_GOOD:
                return True
        return False

    def _reloc_add_matches(self, frame, kf: int, matches, pose, radius: float):
        """Projection search of the candidate keyframe's points not yet
        matched (reference SearchByProjection(CurFrame, KF, sFound, r, th),
        src/FeatureMatcher.cc:1406-1506), no ratio test. Returns (merged
        matches, number added)."""
        m = self.map
        kf_m = m.kf_matches[kf]
        cand = np.setdiff1d(np.unique(kf_m[kf_m >= 0]), matches[matches >= 0]).astype(np.int64)
        cand = cand[m.pt_valid[cand]]
        if len(cand) == 0:
            return matches, 0
        bucket = _pad_pow2(len(cand), lo=256)
        idx = np.concatenate([cand, np.zeros(bucket - len(cand), np.int64)])
        pad_valid = np.arange(bucket) < len(cand)
        blk = m.mirror().gather(idx)
        feats = frame.feats
        res = frame_ops.project_and_match(
            *blk[:7], self._to_dev(pad_valid), self._to_dev(pose.astype(np.float32)),
            *self.intrinsics, *self._bounds_d, feats.dev("uv_und"), feats.dev("desc_bits"),
            feats.dev("size"), feats.dev("valid"), float(radius), self.cfg.match_th, None)
        res = {k: _host(v) for k, v in res.items()}
        merged = matches.copy()
        n_added = 0
        for s_ in np.nonzero(res["valid"])[0]:
            slot = int(res["idx"][s_])
            if merged[slot] < 0:
                merged[slot] = int(idx[s_])
                n_added += 1
        return merged, n_added

    # --------------------------------------------------------- keyframes
    def _need_new_keyframe(self, frame: FrameData) -> bool:
        """Reference NeedNewKeyFrame (src/Tracking.cc:838-922), with the
        close-point terms and reference ratios of depth sensors. c1b needs
        local mapping idle (no solve in flight, no queued event); a wanted
        keyframe while mapping is busy interrupts it (reference InterruptBA,
        Tracking.cc:905-918). Never in localization mode."""
        cfg = self.cfg
        if self.only_tracking:
            return False
        n_kf = self.map.n_keyframes()
        if frame.frame_id < self.last_reloc_frame_id + cfg.max_frames and n_kf > cfg.max_frames:
            return False
        mono = cfg.sensor == "monocular"
        min_obs = 3 if n_kf > 2 else 2
        counts = self.map.point_observation_counts(stereo_weighted=not mono)
        ref_m = self.map.kf_matches[self.ref_kf]
        ref_pts = ref_m[ref_m >= 0]
        n_ref = int((counts[ref_pts] >= min_obs).sum())
        if n_ref < 15 and min_obs > 2:
            # a fresh map component inside a mature map: its points have
            # only 2 observations, so fall back to min_obs = 2
            n_ref = int((counts[ref_pts] >= 2).sum())
        need_close = False
        if not mono and "depth" in frame.feats:
            d = frame.feats["depth"]
            close = frame.feats["valid"] & (d > 0) & (d < cfg.th_depth)
            tracked = close & (frame.matches >= 0)
            # minTrackedClose = 100, minNonTrackedClose = 70 (Tracking.h:296-297)
            need_close = int(tracked.sum()) < 100 and int((close & ~tracked).sum()) > 70
        if mono:
            th_ref = cfg.kf_ref_ratio        # 0.9
        elif n_kf < 2:
            th_ref = 0.4                     # refRatio_low_needNewKey
        else:
            th_ref = 0.75                    # refRatio_medium_needNewKey
        frames_since = frame.frame_id - self.last_kf_frame_id
        c1a = frames_since >= cfg.max_frames
        c1b = frames_since >= 0 and self.mapping_idle()
        c1c = not mono and (self.n_inliers < n_ref * 0.25 or need_close)
        c2 = ((self.n_inliers < n_ref * th_ref) or need_close) \
            and self.n_inliers > cfg.kf_min_inliers
        need = (c1a or c1b or c1c) and c2
        if not need and c2 and not self.mapping_idle():
            self.interrupt_mapping()
        return need

    def _create_depth_points(self, frame: FrameData, kf: int):
        """A depth sensor's keyframe mints map points from its depth: every
        close keypoint (depth < th_depth), and at least the 100 nearest
        (reference CreateNewKeyFrame, src/Tracking.cc:933-979)."""
        d = frame.feats["depth"]
        slots = np.nonzero(frame.feats["valid"] & (d > 0))[0]
        if len(slots) == 0:
            return
        slots = slots[np.argsort(d[slots], kind="stable")]
        counted = np.arange(1, len(slots) + 1)
        stop = np.nonzero((d[slots] > self.cfg.th_depth) & (counted > 100))[0]
        if len(stop):
            slots = slots[: stop[0]]
        m = self.map
        create = slots[m.kf_matches[kf][slots] < 0]
        create = create[: int((~m.pt_valid).sum())]
        if len(create) == 0:
            return
        ids = m.add_points(self._unproject_depth(frame, create, frame.pose),
                           frame.feats["desc_bits"][create], kf, frame.feats["size"][create])
        m.kf_matches[kf][create] = ids
        m.update_point_stats(ids)
        frame.matches[create] = ids

    def _create_new_keyframe(self, frame: FrameData):
        with perfcount.span("track.keyframe", frame.frame_id):
            # break the device chain: the keyframe's pose is synced with the
            # mapping's refinements below, and the next frame re-anchors on it
            self._chain = None
            frame.feats.fetch_all()  # before taking the lock
            with self.map_lock:
                kf = self.map.add_keyframe(frame.pose, frame.ts, frame.frame_id, frame.feats,
                                           frame.matches.copy())
                if self.on_keyframe_feats:
                    self.on_keyframe_feats(kf, frame.feats)
                self.ref_kf = kf
                self.last_kf_frame_id = frame.frame_id
                if self.cfg.sensor != "monocular" and "depth" in frame.feats:
                    self._create_depth_points(frame, kf)
            if self.on_new_keyframe:
                self.on_new_keyframe(kf)
            # mapping may have refined poses (synchronous); keep the frame in sync
            frame.pose = self.map.kf_pose[kf].copy()
            frame.matches = self.map.kf_matches[kf].copy()
