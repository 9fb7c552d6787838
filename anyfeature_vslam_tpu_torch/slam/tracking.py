"""Tracking: the per-frame state machine (port of
anyfeature_vslam_tpu/slam/tracking.py, synchronous monocular path).

The counterpart of the reference Tracking thread (reference
src/Tracking.cc): NOT_INITIALIZED -> OK -> LOST, with two-view
initialization, the fused tracked frame (slam/fast_track.py: motion-model
search, reference-keyframe fallback, local-map search, pose LMs), the
staged per-stage path for the frame after initialization, and the
monocular keyframe decision (Tracking.cc:838-922).

Frames are processed in order, each to its end (the JAX package's
``pipeline_depth=0``): the pipelined dispatch/retire tracker is ROADMAP
queue item 8. A LOST frame relocalizes against the keyframe database
(``database``, set by the System with its vocabulary; without one it stays
LOST): BoW candidates, one K2 search per candidate, batched RANSAC-EPnP,
pose LM, projection add-match rounds and the local map (reference
Relocalization, src/Tracking.cc:1146-1309). Per-frame compute runs on the
tracker's device; the map and bookkeeping are numpy on the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch

from .. import perfcount
from ..frontend.extractor import ExtractorConfig, OrbExtractor
from ..ops import camera as cam_ops
from ..ops import initializer, pnp, pose_opt
from . import fast_track, frame_ops
from .map_state import SlamMap


RELOC_MAX_CANDIDATES = 8   # the JAX package's fixed candidate capacity
RELOC_MIN_MATCHES = 15     # reference: >= 15 BoW matches per candidate
RELOC_MIN_PNP = 10         # reference: >= 10 PnP / pose-LM inliers
RELOC_GOOD = 50            # reference: success at >= 50 inliers


class TrackState(Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class TrackingConfig:
    n_features: int = 1000
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
    finished: bool = False


def _pad_pow2(n, lo=256):
    """Coarse 4x-step padding of the local-map block."""
    c = lo
    while c < n:
        c *= 4
    return c


class Tracker:
    def __init__(self, cfg: TrackingConfig, camera: cam_ops.CameraParams, slam_map: SlamMap,
                 device="cuda"):
        if cfg.detector != "fast" or cfg.descriptor != "bin256":
            raise NotImplementedError(
                "the torch port tracks orb32 only; the other feature families are "
                "ROADMAP.md queue item 9")
        self.cfg = cfg
        self.device = torch.device(device)
        self.cam = camera
        self.map = slam_map
        self.state = TrackState.NOT_INITIALIZED
        h, w = camera.height, camera.width
        self.extractor = OrbExtractor(ExtractorConfig(
            n_features=cfg.n_features, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
            detect_th=cfg.detect_th), h, w).to(self.device)
        # the init extractor uses 2x features (reference Tracking.h:239)
        self.extractor_init = OrbExtractor(ExtractorConfig(
            n_features=2 * cfg.n_features, n_levels=cfg.n_levels,
            scale_factor=cfg.scale_factor, detect_th=cfg.detect_th), h, w).to(self.device)
        b = [float(v) for v in cam_ops.undistorted_bounds(camera)]
        self.bounds_lo = np.array([b[0], b[2]], np.float32)
        self.bounds_hi = np.array([b[1], b[3]], np.float32)
        self._bounds_d = (torch.from_numpy(self.bounds_lo).to(self.device),
                          torch.from_numpy(self.bounds_hi).to(self.device))
        self.intrinsics = tuple(float(v) for v in (camera.fx, camera.fy, camera.cx, camera.cy))
        self._k = camera.k_matrix
        self.velocity = None          # T_cur_last
        self._fast_state = None
        # the last fused step's device outputs (carry + pose), chained to
        # the next frame
        self._chain = None
        self.last: FrameData | None = None
        self.init_ref: FrameData | None = None
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self.last_reloc_frame_id: int = -(10 ** 9)
        self.frame_id = 0
        self.n_inliers = 0
        self.trajectory: list = []    # per frame (ts, T_cur_ref, ref_kf uid, lost)
        self.on_new_keyframe = None   # callback(kf_id) -> local mapping
        self.on_keyframe_feats = None  # callback(kf_id, DeviceFeats)
        self.on_reset = None          # callback() after a map reset
        self.kf_dev = None            # keyframe -> its feature tensors
        self.database = None          # KeyFrameDatabase (relocalization)
        self.stats = dict(tracked_frames=0, lost_frames=0, resets=0, relocalizations=0)

    def _to_dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _image(self, img):
        """(H, W) image -> uint8 tensor on the device."""
        if isinstance(img, torch.Tensor):
            return img.to(self.device)
        img8 = img if img.dtype == np.uint8 else np.clip(img, 0, 255).astype(np.uint8)
        return self._to_dev(img8)

    # ------------------------------------------------------------ frontend
    def _extract(self, img, init: bool) -> DeviceFeats:
        ext = self.extractor_init if init else self.extractor
        feats = ext(self._image(img).to(torch.float32))
        feats["uv_und"] = cam_ops.undistort_points(self.cam, feats["xy"]).to(torch.float32)
        return DeviceFeats(feats)

    # ------------------------------------------------------------ main API
    def process_frame(self, img, ts: float):
        fid = self.frame_id
        self.frame_id += 1
        # a tracked frame's extraction runs inside the fused step
        defer_extract = self.state == TrackState.OK
        feats = None if defer_extract else self._extract(
            img, init=self.state == TrackState.NOT_INITIALIZED)
        frame = FrameData(fid, ts, feats)
        self._run_state_machine(frame, img)
        return self.state

    def _run_state_machine(self, frame: FrameData, img=None):
        """Per-frame state transitions (reference Track(), Tracking.cc:154-388)."""
        if self.state == TrackState.NOT_INITIALIZED:
            self._monocular_initialization(frame)
        elif self.state == TrackState.OK:
            if not self._track(frame, img):
                self.state = TrackState.LOST
                self.stats["lost_frames"] += 1
                # reference: reset the whole system if lost early (:355-363)
                if self.map.n_keyframes() <= 5:
                    self._reset()
        elif self._relocalization(frame):
            self.state = TrackState.OK
            self.stats["relocalizations"] += 1
            self.last_reloc_frame_id = frame.frame_id
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

    def _reset(self):
        m = self.map
        m.__init__(m.max_kf, m.max_pt, m.n_feat, m.desc_dim, m.desc_dtype, m.device)
        self.state = TrackState.NOT_INITIALIZED
        self.velocity = None
        self.last = None
        self.init_ref = None
        self.ref_kf = -1
        self._fast_state = None
        self._chain = None
        self.stats["resets"] += 1
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
        ref = self.init_ref
        keys = ("uv_und", "desc_bits", "octave", "angle", "valid")
        res = frame_ops.match_for_initialization(
            *(ref.feats.dev(k) for k in keys), *(frame.feats.dev(k) for k in keys),
            cfg.init_window, cfg.match_th, cfg.init_ratio)
        res = {k: _host(v) for k, v in res.items()}
        if int(res["valid"].sum()) < cfg.min_init_matches:
            self.init_ref = None  # reference Tracking.cc:469-476
            return
        uv1 = ref.feats["uv_und"]
        uv2 = frame.feats["uv_und"][res["idx"]]
        init = initializer.initialize_two_view(
            self._to_dev(uv1), self._to_dev(uv2.astype(np.float32)), self._to_dev(res["valid"]),
            self._k, cfg.seed)
        init = {k: _host(v) for k, v in init.items()}
        if not bool(init["success"]):
            return
        self._create_initial_map(ref, frame, res, init)

    def _create_initial_map(self, ref: FrameData, frame: FrameData, match, init):
        """Reference CreateInitialMapMonocular (Tracking.cc:510-599)."""
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
        if self.on_new_keyframe:
            self.on_new_keyframe(kf1)
            self.on_new_keyframe(kf2)

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
        fast = self._try_fast_track(frame, img)
        if fast is not None and not fast:
            return False  # the fused step's failure is authoritative
        if fast is None:
            # the fused step does not apply (the frame after
            # initialization carries the 2x init extraction): the staged
            # path, motion -> ref-KF -> local map (reference Track()
            # :293-316)
            frame.feats = self._extract(img, init=False)
            frame.pose = None
            frame.matches = None
            ok = False
            if self.velocity is not None and frame.frame_id >= self.last_reloc_frame_id + 2:
                ok = self._track_motion_model(frame)
            if not ok:
                ok = self._track_reference_kf(frame)
            if ok:
                ok = self._track_local_map(frame)
            if not ok:
                return False
        # velocity update (reference Tracking.cc:340-350)
        if self.last is not None and self.last.pose is not None:
            self.velocity = frame.pose @ np.linalg.inv(self.last.pose)
        self.last = frame
        if self._need_new_keyframe(frame):
            self._create_new_keyframe(frame)
        return True

    def _pose_optimize(self, frame: FrameData, matches: np.ndarray, init_pose):
        """matches: (N,) kp -> pt id. Returns (pose, inlier matches, n_inliers)."""
        has = matches >= 0
        pts = self.map.pt_pos[np.where(has, matches, 0)]
        t, inlier, n_in = pose_opt.pose_optimize(
            self._to_dev(init_pose.astype(np.float32)), self._to_dev(pts),
            frame.feats.dev("uv_und"), frame.feats.dev("inv_sigma2"),
            self._to_dev(has & frame.feats["valid"]), *self.intrinsics)
        inlier = _host(inlier)
        return _host(t), np.where(inlier, matches, -1).astype(np.int32), int(n_in)

    def _track_motion_model(self, frame: FrameData) -> bool:
        cfg = self.cfg
        last = self.last
        pred_pose = (self.velocity @ last.pose).astype(np.float32)
        has_pt = last.matches >= 0
        pts = self.map.pt_pos[np.where(has_pt, last.matches, 0)]
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
        pose, matches, n_in = self._pose_optimize(frame, matches, pred_pose)
        frame.pose = pose
        frame.matches = matches
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
        """The tracked frame in one fused step. Returns True / False (the
        tracking outcome) or None when the fused step does not apply."""
        cfg = self.cfg
        m = self.map
        chain = self._chain
        if chain is not None and chain["fid"] != frame.frame_id - 1:
            chain = None  # a slow or lost frame broke the chain
        if chain is None:
            last = self.last
            if (last is None or last.pose is None or last.matches is None
                    or not isinstance(last.feats, DeviceFeats)
                    # the post-init frame carries the 2x-capacity init extraction
                    or int(last.feats.dev("uv_und").shape[0]) != m.n_feat):
                return None
            chain = dict(fid=last.frame_id, carry=self._build_fast_carry(),
                         pose=self._to_dev(last.pose.astype(np.float32)))
        fs = self._fast_state
        if fs is None or fs["rev"] != m.rev:
            # the map changed (a keyframe event): rebuild the device
            # snapshot, and re-anchor the chain on the host's refined state
            fs = self._fast_state = self._build_fast_state()
            if fs is None:
                return None
            if self.last is not None and self.last.frame_id == chain["fid"]:
                chain = dict(fid=self.last.frame_id, carry=self._build_fast_carry(),
                             pose=self._to_dev(self.last.pose.astype(np.float32)))
        reloc_ok = frame.frame_id >= self.last_reloc_frame_id + 2
        if self.last is not None and self.last.pose is not None \
                and self.last.frame_id == chain["fid"]:
            # prediction and LM seed from the host poses, which carry every
            # mapping-side refinement
            use_motion = self.velocity is not None and reloc_ok
            pred = self.velocity @ self.last.pose if use_motion else self.last.pose
            pred = self._to_dev(pred.astype(np.float32))
            last_pose = self._to_dev(self.last.pose.astype(np.float32))
        else:
            use_motion = False
            pred = last_pose = chain["pose"]
        carry = chain["carry"]
        fx, fy, cx, cy = self.intrinsics
        feats_d, out = fast_track.fused_extract_track(
            self._image(img), self.cam, self.extractor,
            **{f"last_{k}": v for k, v in carry.items()}, **fs["ref"], **fs["block"],
            pred_pose=pred, last_pose=last_pose, use_motion=use_motion,
            bounds_lo=self._bounds_d[0], bounds_hi=self._bounds_d[1],
            fx=fx, fy=fy, cx=cx, cy=cy, motion_radius=float(cfg.motion_radius),
            match_th=float(cfg.match_th), min_motion_matches=cfg.min_motion_matches,
            refkf_ratio=float(cfg.refkf_ratio), local_radius=float(cfg.local_radius),
            local_ratio=float(cfg.local_ratio), min_track_inliers=cfg.min_track_inliers)
        frame.feats = feats = DeviceFeats(feats_d)
        pose_d, pt_d, n_in_d, vis_d, ok1_d, _, pos_d = out
        self._chain = dict(
            fid=frame.frame_id,
            carry=dict(uv=feats.dev("uv_und"), bits=feats.dev("desc_bits"),
                       size=feats.dev("size"), angle=feats.dev("angle"),
                       match_pt=pt_d, match_pos=pos_d),
            pose=pose_d)
        return self._fast_retire(frame, fs, pose_d, pt_d, n_in_d, vis_d, ok1_d)

    def _fast_retire(self, frame, fs, pose_d, pt_d, n_in_d, vis_d, ok1_d) -> bool:
        """Host bookkeeping of a fused step's results."""
        m = self.map
        if not bool(ok1_d):
            # both branches failed: tracking lost (reference Track() :293-316)
            self._chain = None
            return False
        frame.pose = _host(pose_d).astype(np.float32)
        matches = _host(pt_d).astype(np.int32)
        # resolve points merged/culled since the snapshot before counting
        self._resolve_stale_matches(matches)
        frame.matches = matches
        n_in = int(n_in_d)
        self.n_inliers = n_in
        vis = _host(vis_d)
        m.pt_visible[fs["blk_ids_np"][vis & fs["blk_valid_np"]]] += 1
        m.pt_found[matches[matches >= 0]] += 1
        self._update_ref_kf_from_matches(matches)
        if n_in < self.cfg.min_local_inliers:
            self._chain = None
            return False
        return True

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
        pose LM; success needs >= 50 inliers after the local map."""
        if self.database is None:
            return False
        t0 = time.perf_counter()
        try:
            return self._relocalization_impl(frame)
        finally:
            dt = time.perf_counter() - t0
            perfcount.bump("t_reloc_s", dt)
            perfcount.event("reloc", fid=frame.frame_id, dur=dt)

    def _relocalization_impl(self, frame: FrameData) -> bool:
        m = self.map
        cfg = self.cfg
        feats = frame.feats
        cands = [int(k) for k in self.database.detect_relocalization_candidates(
            feats.dev("desc_bits"), feats.dev("valid"), m) if m.kf_valid[int(k)]]
        cands = cands[:RELOC_MAX_CANDIDATES]
        if not cands:
            return False
        # one K2 search per candidate, on its descriptors packed once and
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
        """Reference NeedNewKeyFrame (src/Tracking.cc:838-922), monocular.
        Local mapping runs each event to its end, so it is always idle
        here and c1b passes: a keyframe is minted whenever c2 holds (the
        JAX package's synchronous behaviour, kept for parity)."""
        cfg = self.cfg
        n_kf = self.map.n_keyframes()
        if frame.frame_id < self.last_reloc_frame_id + cfg.max_frames and n_kf > cfg.max_frames:
            return False
        min_obs = 3 if n_kf > 2 else 2
        counts = self.map.point_observation_counts()
        ref_m = self.map.kf_matches[self.ref_kf]
        ref_pts = ref_m[ref_m >= 0]
        n_ref = int((counts[ref_pts] >= min_obs).sum())
        if n_ref < 15 and min_obs > 2:
            # a fresh map component inside a mature map: its points have
            # only 2 observations, so fall back to min_obs = 2
            n_ref = int((counts[ref_pts] >= 2).sum())
        frames_since = frame.frame_id - self.last_kf_frame_id
        c1a = frames_since >= cfg.max_frames
        c1b = frames_since >= 0  # and local mapping idle
        c2 = (self.n_inliers < n_ref * cfg.kf_ref_ratio) and self.n_inliers > cfg.kf_min_inliers
        return (c1a or c1b) and c2

    def _create_new_keyframe(self, frame: FrameData):
        # break the device chain: the keyframe's pose is synced with the
        # mapping's refinements below, and the next frame re-anchors on it
        self._chain = None
        frame.feats.fetch_all()
        kf = self.map.add_keyframe(frame.pose, frame.ts, frame.frame_id, frame.feats,
                                   frame.matches.copy())
        if self.on_keyframe_feats:
            self.on_keyframe_feats(kf, frame.feats)
        self.ref_kf = kf
        self.last_kf_frame_id = frame.frame_id
        if self.on_new_keyframe:
            self.on_new_keyframe(kf)
        # mapping has refined poses (synchronous); keep the frame in sync
        frame.pose = self.map.kf_pose[kf].copy()
        frame.matches = self.map.kf_matches[kf].copy()
