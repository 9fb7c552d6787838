"""Local mapping: keyframe processing, triangulation, fusion, culling and
local BA (port of anyfeature_vslam_tpu/slam/local_mapping.py).

Per new keyframe (reference LocalMapping::Run, src/LocalMapping.cc:48-119):
observation bookkeeping, recent-map-point culling (:194-229), new-point
triangulation against the best covisible keyframes (:231-473), fusion with
the neighbours in both directions (:475-555), local bundle adjustment with
outlier erasure (two-stage schedule, reference src/Optimizer.cc:450-768)
and redundant-keyframe culling (:651-741). Outside monocular (RGB-D,
stereo) fusion and triangulation take 10 neighbours instead of 20, and
culling counts only a keyframe's close depth points.

Each device program is a dispatch (``_dispatch_*``: the searches issued,
their results copied toward the host behind a ``streams.Ready`` probe) and
a fold (``_fold_*``: the results written into the host map, guarded by
keyframe uid and point validity). Synchronously (``defer_ba=False,
overlap_results=False``) each dispatch is folded at once. With
``defer_ba`` the local BA solve is issued on the mapping stream and left
running; its fold lands at the next event, at the tracker's interrupt or
at a loop stage's ``pre_mutate`` (asynchronous mapping), or from a watcher
thread as soon as its results are on the host (threaded mapping, with
``overlap_results``: triangulation and fusion are issued together and
waited on with the map lock released). Device work: the triangulation
searches (dense masked Hamming), one K2 launch per fusion target and
direction, and the BA solve; the keyframes' features stay on the device
in a per-keyframe cache.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from .. import perfcount, streams
from ..ops import ba as ba_ops
from ..ops import cuda_match
from ..parallel import sharded_ba
from . import frame_ops
from .map_state import SlamMap

TRI_RATIO = 0.6          # reference matcher(0.6) for triangulation
MIN_BASELINE_DEPTH_RATIO = 0.01  # reference LocalMapping.cc:284-288


def _pad_sched(n, schedule):
    """Smallest bucket in `schedule` >= n (beyond the last, x4 steps)."""
    for c in schedule:
        if n <= c:
            return c
    c = schedule[-1]
    while c < n:
        c *= 4
    return c


def _resolve_merge_chains(pairs):
    """Sequential-equivalent filtering of a batch of (keep, drop) merge
    pairs: a pair whose endpoint an earlier merge already dropped is
    skipped (MapPoint::Replace checks isBad, src/MapPoint.cc:213-224), and
    each drop maps to the end of its forward chain. Returns (keeps, drops)."""
    fwd = {}
    dropped = set()

    def find(x):
        while x in fwd:
            x = fwd[x]
        return x

    for keep, drop in pairs:
        keep, drop = int(keep), int(drop)
        if keep == drop or keep in dropped or drop in dropped:
            continue
        fwd[drop] = keep
        dropped.add(drop)
    drops = list(fwd.keys())
    return [find(d) for d in drops], drops


def run_bundle_adjustment(slam_map: SlamMap, intrinsics, free_kfs, fixed_kfs, pt_ids,
                          n_iters_a: int = 5, n_iters_b: int = 10,
                          remove_outliers: bool = True, device="cuda", defer: bool = False,
                          stream=None, lock=None, mesh=None, keep_problem: bool = False):
    """Assemble COO arrays from the map, run the two-stage LM on `device`
    and write refined poses (free keyframes) and points back into the map;
    erase outlier observations (reference src/Optimizer.cc:701-747).
    intrinsics: (fx, fy, cx, cy) as Python floats. Returns the problem's
    sizes and padded caps, or None when there was nothing to solve.

    defer=True returns a ``fold()`` closure instead of writing back: the
    solve is issued (on `stream`, when given) and its results copied to
    pinned host buffers, and ``fold.ready`` (a ``streams.Ready``) says when
    they have landed; ``fold.info`` holds the sizes. fold() writes them into
    the map, guarded by keyframe uid (a slot culled meanwhile may hold
    another keyframe) and by point validity. `lock`, when given, is held
    while the problem is read from the map. With a `mesh`
    (parallel/sharded_ba.Mesh) whose size divides the padded observation
    count, the solve is observation-sharded over its ranks (always the CG
    path), as the JAX package does; the ranks must assemble the same
    problem (Mesh.check_same raises otherwise). keep_problem: the sizes
    also hold the padded host arrays under "problem"."""
    with lock if lock is not None else contextlib.nullcontext():
        prob = _assemble_ba(slam_map, free_kfs, fixed_kfs, pt_ids)
    if prob is None:
        return None
    kf_list, free_kfs, pt_ids, obs_kf, obs_slot, arrays, info = prob
    kf_uids = {kf: int(slam_map.kf_uid[kf]) for kf in kf_list}
    sharded = mesh is not None and info["o_cap"] % mesh.size == 0
    if sharded:
        info.update(dense=False, mesh=mesh.size)
    if keep_problem:
        info["problem"] = arrays
    with streams.use(stream if defer else None):
        if mesh is not None:
            mesh.check_same(*arrays, np.array([*intrinsics, n_iters_a, n_iters_b], np.float64))
        up = [torch.from_numpy(a).to(device) for a in arrays]
        if sharded:
            new_poses, new_pts, chi2, z, _ = sharded_ba.sharded_bundle_adjust_two_stage(
                mesh, *up, *intrinsics, n_iters_a=n_iters_a, n_iters_b=n_iters_b)
        else:
            new_poses, new_pts, chi2, z, _ = ba_ops.bundle_adjust_two_stage(
                *up, *intrinsics, n_iters_a=n_iters_a, n_iters_b=n_iters_b)
        outlier = ba_ops.classify_outliers(chi2, z)
        ready = streams.Ready((new_poses[: len(free_kfs)], new_pts[: len(pt_ids)],
                               outlier[: info["n_obs"]]))

    def fold():
        """Write the landed results into the map (reference LocalMapping
        overlap with mbAbortBA, src/LocalMapping.cc:48-119: until the fold,
        tracking keeps using the pre-BA state)."""
        np_poses, np_pts, np_outlier = ready.host()
        info["n_outliers"] = int(np_outlier.sum())
        slam_map.rev += 1

        def same_kf(kf):
            return slam_map.kf_valid[kf] and int(slam_map.kf_uid[kf]) == kf_uids[kf]

        for li, kf in enumerate(free_kfs):
            if same_kf(kf):
                slam_map.kf_pose[kf] = np_poses[li]
        still = slam_map.pt_valid[pt_ids]
        slam_map.pt_pos[pt_ids[still]] = np_pts[still]
        slam_map.mark_points_dirty(pt_ids[still])
        if remove_outliers:
            for i in np.nonzero(np_outlier)[0]:
                kf = kf_list[obs_kf[i]]
                if same_kf(kf):
                    slam_map.kf_matches[kf][obs_slot[i]] = -1

    if defer:
        fold.ready = ready
        fold.info = info
        return fold
    fold()
    return info


def _assemble_ba(slam_map, free_kfs, fixed_kfs, pt_ids):
    """The BA problem read from the host map: (keyframes, free keyframes,
    point ids, observation keyframe index and slot, the padded arrays
    (poses, points, free, obs kf, obs point, uv, weight, valid), sizes), or
    None when there is nothing to solve."""
    free_kfs = [int(k) for k in free_kfs]
    fixed_kfs = [int(k) for k in fixed_kfs if k not in free_kfs]
    kf_list = free_kfs + fixed_kfs
    if not kf_list:
        return None
    pt_ids = np.asarray(sorted(int(p) for p in pt_ids), np.int64)
    pt_ids = pt_ids[slam_map.pt_valid[pt_ids]]
    if len(pt_ids) == 0:
        return None
    pt_local = np.full(slam_map.max_pt, -1, np.int64)
    pt_local[pt_ids] = np.arange(len(pt_ids))

    obs_kf, obs_slot, obs_pt, obs_uv, obs_w = [], [], [], [], []
    for li, kf in enumerate(kf_list):
        m = slam_map.kf_matches[kf]
        sl = np.nonzero((m >= 0) & (pt_local[np.clip(m, 0, None)] >= 0))[0]
        obs_kf.append(np.full(len(sl), li, np.int64))
        obs_slot.append(sl)
        obs_pt.append(pt_local[m[sl]])
        obs_uv.append(slam_map.kf_uv[kf][sl])
        obs_w.append(slam_map.kf_inv_sigma2[kf][sl])
    obs_kf = np.concatenate(obs_kf)
    obs_slot = np.concatenate(obs_slot)
    n_obs = len(obs_kf)
    if n_obs < 10:
        return None

    # the JAX package's coarse ladders: the padded sizes choose the solver
    # (dense Schur or CG), so the two packages solve the same way
    k_cap = _pad_sched(len(kf_list), (4, 64, 1024))
    p_cap = _pad_sched(len(pt_ids), (256, 2048, 8192, 65536))
    o_cap = _pad_sched(n_obs, (1024, 8192, 32768, 262144))

    poses = np.tile(np.eye(4, dtype=np.float32), (k_cap, 1, 1))
    poses[: len(kf_list)] = slam_map.kf_pose[kf_list]
    pts = np.zeros((p_cap, 3), np.float32)
    pts[: len(pt_ids)] = slam_map.pt_pos[pt_ids]
    free = np.zeros(k_cap, bool)
    free[: len(free_kfs)] = True

    def padded(a, shape, dtype):
        out = np.zeros(shape, dtype)
        out[:n_obs] = a
        return out

    arrays = (poses, pts, free, padded(obs_kf, o_cap, np.int64),
              padded(np.concatenate(obs_pt), o_cap, np.int64),
              padded(np.concatenate(obs_uv), (o_cap, 2), np.float32),
              padded(np.concatenate(obs_w), o_cap, np.float32),
              padded(np.ones(n_obs, bool), o_cap, bool))
    info = dict(n_kf=len(kf_list), n_pt=len(pt_ids), n_obs=n_obs, k_cap=k_cap, p_cap=p_cap,
                o_cap=o_cap, dense=ba_ops.uses_dense(k_cap, p_cap))
    return kf_list, free_kfs, pt_ids, obs_kf, obs_slot, arrays, info


class LocalMapper:
    """Local mapping over a SlamMap. intrinsics: (fx, fy, cx, cy) Python
    floats; width, height: the image size (fusion bounds); device: where
    the mapping programs run; lock: the System's map lock (a private one
    otherwise), held only around the event's map mutations; sensor,
    th_depth: the tracker's (System.h:54-60, the close-point depth);
    mesh: a parallel/sharded_ba.Mesh over which local BA runs sharded."""

    # neighbour schedules of the JAX package (targets are processed up to
    # the padded count; see _pad_sched)
    FUSE_T_SCHEDULE = (16, 32, 64, 128)
    TRI_T_SCHEDULE = (8, 20, 32)

    def __init__(self, slam_map: SlamMap, intrinsics, width: int, height: int,
                 match_th: float = 75.0, max_ba_kfs: int = 20, size_tolerance: float = 1.2,
                 sensor: str = "monocular", th_depth: float = 0.0,
                 device="cuda", lock=None, mesh=None):
        self.map = slam_map
        self.mesh = mesh
        self.intrinsics = tuple(float(v) for v in intrinsics)
        fx, fy, cx, cy = self.intrinsics
        self.k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        self.width, self.height = int(width), int(height)
        self.match_th = match_th
        self.max_ba_kfs = max_ba_kfs
        self.sensor = sensor
        self.th_depth = float(th_depth)
        # sizeTolerance = extractor scale factor (reference src/Frame.cc:73)
        self.size_tolerance = float(size_tolerance)
        self.device = torch.device(device)
        self.lock = lock if lock is not None else threading.RLock()
        # the stream of the deferred solves (the System's mapping stream on
        # the card; None: the current stream)
        self.stream = None
        # True between recent-point culling and the triangulation / fusion
        # folds, where the map is temporarily sparse (the tracker does not
        # build its snapshot there)
        self.in_sparse_phase = False
        # non-zero once an overlapped event's folds have landed: the token
        # of that event (the tracker rebuilds its snapshot promptly so the
        # new points become matchable, and clears the token it saw)
        self.fresh_event = 0
        self._n_events = 0
        self.reset()

    def reset(self):
        """Forget the recent points, the keyframe cache and a pending fold
        (a map reset: the fold's results belong to the old map)."""
        # recent points: pt_id -> keyframe count at creation (for culling)
        self.recent: dict[int, int] = {}
        self.n_kf_processed = 0
        # per-keyframe feature tensors on the device, keyed by slot and
        # guarded by uid against slot recycling, with their hand-off
        self._dev_kf: dict[int, tuple] = {}
        self._pending_fold = None
        self.ba_log: list[dict] = []
        # the last local BA's padded host arrays (run_bundle_adjustment's
        # order) and its sizes
        self.last_ba_problem: tuple | None = None

    _DEV_FIELDS = ("uv", "bits", "size", "valid", "inv_sigma2", "angle")

    def _cache(self, kf: int, ent: dict):
        """Prepare the descriptors (``words``: packed, or float rows with
        their norms) and cache the entry with its hand-off (the tensors
        were produced on the current stream)."""
        ent["words"] = cuda_match.pack_candidates(ent["bits"])
        self._dev_kf[int(kf)] = (int(self.map.kf_uid[kf]), ent, streams.Handoff(ent.values()))

    def seed_kf_device(self, kf: int, feats):
        """Adopt a new keyframe's features already on the device."""
        self._cache(kf, dict(uv=feats.dev("uv_und"), bits=feats.dev("desc_bits"),
                             size=feats.dev("size"), valid=feats.dev("valid"),
                             inv_sigma2=feats.dev("inv_sigma2"), angle=feats.dev("angle")))

    def kf_dev(self, kf: int) -> dict:
        """The keyframe's feature tensors on the device (uploaded from the
        map on first use), plus its prepared descriptors (``words``), ready
        for the current stream."""
        kf = int(kf)
        uid = int(self.map.kf_uid[kf])
        ent = self._dev_kf.get(kf)
        if ent is None or ent[0] != uid:
            m = self.map
            host = dict(uv=m.kf_uv[kf], bits=m.kf_desc_bits[kf], size=m.kf_size[kf],
                        valid=m.kf_feat_valid[kf], inv_sigma2=m.kf_inv_sigma2[kf],
                        angle=m.kf_angle[kf])
            self._cache(kf, {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                             for k, v in host.items()})
            ent = self._dev_kf[kf]
        ent[2].take()
        return ent[1]

    # ------------------------------------------------------------------
    def fold_pending(self):
        """Land a dispatched local BA (or global BA) before the next map
        mutation."""
        if self._pending_fold is not None:
            f = self._pending_fold
            self._pending_fold = None
            f()

    def flush_results(self):
        """Land the pending deferred fold into the map."""
        self.fold_pending()

    def arm_fold_watcher(self):
        """Land the pending fold from a side thread as soon as its results
        are on the host, under the lock; a no-op if flush_results consumed
        it meanwhile (the worker-thread form of the reference's
        interruptible local BA, src/LocalMapping.cc:78,125)."""
        f = self._pending_fold
        if f is None:
            return

        def run():
            f.ready.wait()
            with self.lock:
                if self._pending_fold is f:
                    self.fold_pending()

        threading.Thread(target=run, daemon=True, name="ba-fold").start()

    def wait_pending_ready(self):
        """Block (lock-free) until the pending fold's results are on the
        host."""
        f = self._pending_fold
        if f is not None:
            f.ready.wait()

    def is_idle(self) -> bool:
        """Reference LocalMapping::AcceptKeyFrames (LocalMapping.cc:576-588):
        busy while a dispatched solve's results have not landed. Gates the
        keyframe decision's c1b."""
        f = self._pending_fold
        return f is None or f.ready.is_set()

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int, defer_ba: bool = False, overlap_results: bool = False):
        """One keyframe event (reference LocalMapping::Run order,
        src/LocalMapping.cc:48-119).

        defer_ba: the local BA is issued and not waited on; it folds at
        the next event, at an interrupt or a loop stage's pre_mutate.

        overlap_results=False: each device program is followed by its fold
        (deterministic). True (threaded mode): triangulation and fusion are
        issued together with the lock released, their results waited on
        with the lock released, then folded under short lock windows; the
        fusion does not see this event's new points (they fuse at the next
        event), as in the JAX package."""
        if self._pending_fold is not None:
            # wait for the previous solve's results with the lock released
            with perfcount.span("map.fold_wait"):
                self.wait_pending_ready()
            with perfcount.span("map.fold"), self.lock:
                self.flush_results()
        m = self.map
        with perfcount.span("map.stats+cullpts"), self.lock:
            self.n_kf_processed += 1
            mm = m.kf_matches[kf]
            m.update_point_stats(np.unique(mm[mm >= 0]))
            # first connection update: spanning-tree parent = max-weight
            # covisible (reference KeyFrame::UpdateConnections)
            if m.kf_parent[kf] < 0 and int(m.kf_uid[kf]) != 0:
                w = m.covisibility_weights(kf)
                w[kf] = 0
                best = int(np.argmax(w))
                if w[best] > 0:
                    m.kf_parent[kf] = best
            self._cull_recent_points()
            self.in_sparse_phase = True
        if m.n_keyframes() >= 2:
            if overlap_results:
                with perfcount.span("map.dispatch"):
                    rec_t = self._dispatch_new_points(kf)
                    rec_f = self._dispatch_fuse(kf)
                with perfcount.span("map.wait"):
                    for rec in (rec_t, rec_f):
                        if rec is not None:
                            rec["ready"].wait()
                with perfcount.span("map.triangulate"):
                    if rec_t is not None:
                        with self.lock:
                            self._fold_new_points(rec_t)
                with perfcount.span("map.fuse"), self.lock:
                    if rec_f is not None:
                        self._fold_fuse(rec_f)
                    self.in_sparse_phase = False
                    self._n_events += 1
                    self.fresh_event = self._n_events
            else:
                with self.lock:
                    with perfcount.span("map.triangulate"):
                        rec = self._dispatch_new_points(kf)
                        if rec is not None:
                            self._fold_new_points(rec)
                    with perfcount.span("map.fuse"):
                        rec = self._dispatch_fuse(kf)
                        if rec is not None:
                            self._fold_fuse(rec)
                        self.in_sparse_phase = False
            with perfcount.span("map.local_ba"):
                self._local_ba(kf, defer=defer_ba)
        self.in_sparse_phase = False
        with perfcount.span("map.cullkfs"), self.lock:
            self._cull_keyframes(kf)

    # ------------------------------------------------------------------
    def _dispatch_fuse(self, kf: int):
        """Reference SearchInNeighbors (LocalMapping.cc:475-555): project the
        new keyframe's points into its first- and second-order covisible
        neighbours and theirs into it (one K2 launch per target and
        direction): 20 first-order neighbours (10 outside monocular,
        reference LocalMapping.cc:477-479) and 5 second-order ones of each.
        Returns a pending record for _fold_fuse, or None."""
        m = self.map
        nn = 20 if self.sensor == "monocular" else 10
        first, _ = m.covisible_keyframes(kf, min_weight=15, max_n=nn)
        targets = []
        for n1 in first:
            targets.append(int(n1))
            second, _ = m.covisible_keyframes(int(n1), min_weight=15, max_n=5)
            targets.extend(int(x) for x in second)
        targets = [t for t in dict.fromkeys(targets) if t != kf and m.kf_valid[t]]
        if not targets:
            return None
        targets = targets[:_pad_sched(len(targets), self.FUSE_T_SCHEDULE)]
        n_t = len(targets)
        n = m.n_feat
        dev = self.device
        mm = m.kf_matches[kf]
        pt_ids = np.unique(mm[mm >= 0])
        pt_ids = pt_ids[m.pt_valid[pt_ids]].astype(np.int64)
        bounds_lo = torch.zeros(2, device=dev)
        bounds_hi = torch.tensor([float(self.width), float(self.height)], device=dev)
        poses = torch.from_numpy(m.kf_pose[np.asarray(targets)]).to(dev)
        rows = [self.kf_dev(t) for t in targets]
        kf_d = self.kf_dev(kf)
        mirror = m.mirror()

        # direction A: the keyframe's points into each target, excluding
        # points the target already observes
        has_t = np.zeros((n_t, m.max_pt), bool)
        for ti, t in enumerate(targets):
            dm = m.kf_matches[t]
            has_t[ti, dm[dm >= 0]] = True
        outs = []
        idx_a = None
        if len(pt_ids):
            idx_a = np.zeros(n, np.int64)
            idx_a[: len(pt_ids)] = pt_ids
            valid_t = np.zeros((n_t, n), bool)
            valid_t[:, : len(pt_ids)] = ~has_t[:, pt_ids]
            ga = mirror.gather(idx_a)
            outs += frame_ops.fuse_points_into_targets(
                *ga[:7], torch.from_numpy(valid_t).to(dev), poses,
                [r["uv"] for r in rows], [r["bits"] for r in rows], [r["size"] for r in rows],
                [r["valid"] for r in rows], *self.intrinsics, bounds_lo, bounds_hi, 3.0,
                self.match_th, f_words_t=[r["words"] for r in rows])
        # direction B: each target's points into the keyframe, excluding
        # points the keyframe observes
        kf_has = np.zeros(m.max_pt, bool)
        kf_has[mm[mm >= 0]] = True
        idx_b = np.zeros((n_t, n), np.int64)
        valid_b = np.zeros((n_t, n), bool)
        for ti, t in enumerate(targets):
            dm = m.kf_matches[t]
            pts = np.unique(dm[dm >= 0])
            pts = pts[m.pt_valid[pts] & ~kf_has[pts]][:n]
            idx_b[ti, : len(pts)] = pts
            valid_b[ti, : len(pts)] = True
        gb = mirror.gather(idx_b)
        outs += frame_ops.fuse_target_points_into_kf(
            *gb[:7], torch.from_numpy(valid_b).to(dev), torch.from_numpy(m.kf_pose[kf]).to(dev),
            kf_d["uv"], kf_d["bits"], kf_d["size"], kf_d["valid"], *self.intrinsics,
            bounds_lo, bounds_hi, 3.0, self.match_th, f_words=kf_d["words"])
        return dict(kf=kf, kf_uid=int(m.kf_uid[kf]), targets=targets,
                    target_uids=[int(m.kf_uid[t]) for t in targets], idx_a=idx_a, idx_b=idx_b,
                    ready=streams.Ready(outs))

    def _fold_fuse(self, rec):
        """Apply a fusion result: add missing observations, merge duplicate
        points (keeping the better-observed one). The keyframe and each
        target are re-validated by uid, proposed points by validity (the
        map may have changed since the dispatch)."""
        m = self.map
        kf = rec["kf"]
        if not m.kf_valid[kf] or int(m.kf_uid[kf]) != rec["kf_uid"]:
            return
        fetched = rec["ready"].host()
        if rec["idx_a"] is not None:
            ia, va, ib, vb = fetched
        else:
            ib, vb = fetched
        targets = rec["targets"]
        n_t = len(targets)
        tgt_ok = [m.kf_valid[t] and int(m.kf_uid[t]) == u
                  for t, u in zip(targets, rec["target_uids"])]
        idx_a, idx_b = rec["idx_a"], rec["idx_b"]
        counts = m.point_observation_counts()
        merge_pairs = []

        def fuse_one(dst_kf, pt, slot):
            if not m.pt_valid[pt]:
                return
            existing = int(m.kf_matches[dst_kf][slot])
            if existing >= 0:
                if existing == pt or not m.pt_valid[existing]:
                    return
                # keep the point with more observations (reference
                # FeatureMatcher.cc:919-931)
                if counts[existing] >= counts[pt]:
                    merge_pairs.append((existing, pt))
                else:
                    merge_pairs.append((pt, existing))
            else:
                m.kf_matches[dst_kf][slot] = pt

        if idx_a is not None:
            for ti in range(n_t):
                if not tgt_ok[ti]:
                    continue
                for s in np.nonzero(va[ti])[0]:
                    fuse_one(targets[ti], int(idx_a[s]), int(ia[ti, s]))
        # two targets can propose the same point for this keyframe (one
        # pre-fuse snapshot); it lands on the first slot only
        kf_gained = set()
        for ti in range(n_t):
            if not tgt_ok[ti]:
                continue
            for s in np.nonzero(vb[ti])[0]:
                pt = int(idx_b[ti, s])
                if pt in kf_gained:
                    continue
                slot = int(ib[ti, s])
                if int(m.kf_matches[kf][slot]) < 0:
                    kf_gained.add(pt)
                fuse_one(kf, pt, slot)
        if merge_pairs:
            keeps, drops = _resolve_merge_chains(merge_pairs)
            perfcount.bump("fuse_points_merged", len(drops))
            m.merge_points(keeps, drops)
        mm = m.kf_matches[kf]
        m.update_point_stats(np.unique(mm[mm >= 0]))

    # ------------------------------------------------------------------
    def _cull_recent_points(self):
        """Reference MapPointCulling (LocalMapping.cc:194-229): drop points
        with found/visible < 0.25, or <= 2 observations two keyframes after
        creation; stop tracking them after three keyframes."""
        to_cull = []
        done = []
        counts = self.map.point_observation_counts()
        for pt, born in self.recent.items():
            if not self.map.pt_valid[pt]:
                done.append(pt)
                continue
            age = self.n_kf_processed - born
            vis = max(int(self.map.pt_visible[pt]), 1)
            ratio = self.map.pt_found[pt] / vis
            if ratio < 0.25:
                to_cull.append(pt)
            elif age >= 2 and counts[pt] <= 2:
                to_cull.append(pt)
            elif age >= 3:
                done.append(pt)
        if to_cull:
            perfcount.bump("recent_points_culled", len(to_cull))
            self.map.remove_points(np.asarray(to_cull))
        for pt in to_cull + done:
            self.recent.pop(pt, None)

    # ------------------------------------------------------------------
    def _dispatch_new_points(self, kf: int):
        """Reference CreateNewMapPoints (LocalMapping.cc:231-473) against up
        to 20 covisible neighbours (10 outside monocular;
        frame_ops.triangulate_with_neighbors). Returns a pending record for
        _fold_new_points, or None."""
        m = self.map
        nn = 20 if self.sensor == "monocular" else 10
        neighbors, _ = m.covisible_keyframes(kf, min_weight=15, max_n=nn)
        neighbors = [int(x) for x in neighbors]
        if not neighbors:
            others = [int(k) for k in m.keyframe_ids() if k != kf]
            if not others:
                return None
            neighbors = [others[-1]]
        t1 = m.kf_pose[kf]
        c1 = -t1[:3, :3].T @ t1[:3, 3]
        keep = []
        for kf2 in neighbors:  # baseline / median-depth gate (:284-288)
            t2 = m.kf_pose[kf2]
            c2 = -t2[:3, :3].T @ t2[:3, 3]
            med = self._median_depth(kf2)
            if med > 0 and float(np.linalg.norm(c2 - c1)) / med >= MIN_BASELINE_DEPTH_RATIO:
                keep.append(kf2)
        if not keep:
            return None
        keep = keep[:_pad_sched(len(keep), self.TRI_T_SCHEDULE)]
        dev = self.device
        t_arr = np.asarray(keep, np.int64)
        unmatched1 = (m.kf_matches[kf] < 0) & m.kf_feat_valid[kf]
        unmatched2 = (m.kf_matches[t_arr] < 0) & m.kf_feat_valid[t_arr]
        rows = [self.kf_dev(t) for t in keep]
        kf_d = self.kf_dev(kf)
        out = frame_ops.triangulate_with_neighbors(
            kf_d["bits"], kf_d["uv"], torch.from_numpy(unmatched1).to(dev), kf_d["inv_sigma2"],
            kf_d["size"], [r["bits"] for r in rows], [r["uv"] for r in rows],
            list(torch.from_numpy(unmatched2).to(dev)), [r["size"] for r in rows],
            [r["inv_sigma2"] for r in rows], torch.from_numpy(t1).to(dev),
            torch.from_numpy(m.kf_pose[t_arr]).to(dev), torch.from_numpy(self.k).to(dev),
            self.match_th, TRI_RATIO)
        return dict(kf=kf, kf_uid=int(m.kf_uid[kf]), targets=keep,
                    target_uids=[int(m.kf_uid[t]) for t in keep], ready=streams.Ready(out))

    def _fold_new_points(self, rec):
        """Apply a triangulation result: create the accepted points and
        their two observations; a current-keyframe slot goes to the first
        (best-covisible) neighbour whose match passed every gate. The
        keyframe and each neighbour are re-validated by uid, and slots are
        claimed only if still unmatched on both sides."""
        m = self.map
        kf = rec["kf"]
        if not m.kf_valid[kf] or int(m.kf_uid[kf]) != rec["kf_uid"]:
            return
        idx2, pts, good = rec["ready"].host()
        col_ok = np.array([bool(m.kf_valid[t]) and int(m.kf_uid[t]) == u
                           for t, u in zip(rec["targets"], rec["target_uids"])])
        good = good & col_ok[:, None] & (m.kf_matches[kf] < 0)[None, :]
        slots1 = np.nonzero(good.any(axis=0))[0]
        if len(slots1) == 0:
            return
        first_t = np.argmax(good[:, slots1], axis=0)  # covisibility order
        slots2 = idx2[first_t, slots1]
        tgt = np.asarray(rec["targets"], np.int64)[first_t]
        free2 = m.kf_matches[tgt, slots2] < 0
        slots1, slots2, tgt, first_t = slots1[free2], slots2[free2], tgt[free2], first_t[free2]
        if len(slots1) == 0:
            return
        ids = m.add_points(pts[first_t, slots1].astype(np.float32), m.kf_desc_bits[kf][slots1],
                           kf, m.kf_size[kf][slots1])
        perfcount.bump("tri_points_added", len(ids))
        m.kf_matches[kf][slots1] = ids
        m.kf_matches[tgt, slots2] = ids
        for p in ids:
            self.recent[int(p)] = self.n_kf_processed
        m.update_point_stats(ids)

    def _median_depth(self, kf: int) -> float:
        mm = self.map.kf_matches[kf]
        ids = mm[mm >= 0]
        if len(ids) == 0:
            return -1.0
        t = self.map.kf_pose[kf]
        pc = self.map.pt_pos[ids] @ t[:3, :3].T + t[:3, 3]
        return float(np.median(pc[:, 2]))

    # ------------------------------------------------------------------
    def _local_ba(self, kf: int, defer: bool = False):
        """Reference LocalBundleAdjustment structure (Optimizer.cc:450-768):
        the keyframe and its covisible keyframes free; keyframes observing
        local points but not covisible fixed. defer: the solve is issued on
        the mapping stream and parked as the pending fold."""
        m = self.map
        with self.lock:
            cov, _ = m.covisible_keyframes(kf, min_weight=1, max_n=self.max_ba_kfs - 1)
            free = [kf] + [int(c) for c in cov]
            pt_ids = set()
            for k in free:
                mm = m.kf_matches[k]
                pt_ids.update(mm[mm >= 0].tolist())
            if not pt_ids:
                return
            pt_mask = np.zeros(m.max_pt, bool)
            pt_mask[list(pt_ids)] = True
            fixed = []
            for other in m.keyframe_ids():
                if other in free:
                    continue
                mm = m.kf_matches[other]
                if pt_mask[mm[mm >= 0]].any():
                    fixed.append(int(other))
        # gauge: if nothing is fixed, fix the oldest free keyframe
        if not fixed and len(free) > 1:
            oldest = min(free)
            free.remove(oldest)
            fixed = [oldest]
        t0 = time.perf_counter()
        res = run_bundle_adjustment(m, self.intrinsics, free, fixed, sorted(pt_ids),
                                    device=self.device, defer=defer, stream=self.stream,
                                    lock=self.lock, mesh=self.mesh, keep_problem=True)
        if res is None:
            return
        info = res.info if defer else res
        self.last_ba_problem = (info.pop("problem"), dict(info))
        info["ms"] = (time.perf_counter() - t0) * 1e3
        info["deferred"] = defer
        self.ba_log.append(info)
        if defer:
            self._pending_fold = res

    # ------------------------------------------------------------------
    def _cull_keyframes(self, kf: int):
        """Reference KeyFrameCulling (LocalMapping.cc:651-741): a covisible
        keyframe is redundant if > 90% of its points (its close depth
        points, for a depth sensor) with > 3 weighted observations are seen
        by >= 3 other keyframes at finer-or-equal scale."""
        m = self.map
        cov, _ = m.covisible_keyframes(kf, min_weight=15)
        counts = m.point_observation_counts(stereo_weighted=True)
        for cand in cov:
            cand = int(cand)
            if int(m.kf_uid[cand]) == 0:
                continue  # never cull the first keyframe
            mm = m.kf_matches[cand]
            slots = np.nonzero(mm >= 0)[0]
            if self.sensor != "monocular":
                # only close depth points count (LocalMapping.cc:678-681)
                d = m.kf_depth[cand][slots]
                slots = slots[(d > 0) & (d <= self.th_depth)]
            if len(slots) < 10:
                continue
            pts = mm[slots]
            okf, oslot, opt = m.observations_of_points(pts)
            other = okf != cand
            size_lut = np.zeros(m.max_pt, np.float32)
            size_lut[pts] = m.kf_size[cand][slots]
            finer = other & (m.kf_size[okf, oslot] <= size_lut[opt] * self.size_tolerance)
            n_finer = np.bincount(opt[finer], minlength=m.max_pt)
            redundant = (counts[pts] > 3) & (n_finer[pts] >= 3)
            if redundant.mean() > 0.9:
                m.remove_keyframe(cand)
