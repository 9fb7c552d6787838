"""Local mapping: keyframe processing, triangulation, fusion, culling and
local BA (port of anyfeature_vslam_tpu/slam/local_mapping.py, synchronous
monocular path).

Per new keyframe (reference LocalMapping::Run, src/LocalMapping.cc:48-119):
observation bookkeeping, recent-map-point culling (:194-229), new-point
triangulation against the best covisible keyframes (:231-473), fusion with
the neighbours in both directions (:475-555), local bundle adjustment with
outlier erasure (two-stage schedule, reference src/Optimizer.cc:450-768)
and redundant-keyframe culling (:651-741).

The event runs to its end before the tracker sees the next frame (the JAX
package's ``defer_ba=False, overlap_results=False``): each device program
is followed by its fold into the host map. The deferred and overlapped
forms (async and threaded mapping) are ROADMAP queue item 8. Device work:
the triangulation searches (dense masked Hamming), one K2 launch per
fusion target and direction, and the BA solve; the keyframes' features
stay on the device in a per-keyframe cache.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import perfcount
from ..ops import ba as ba_ops
from ..ops import cuda_match
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
                          remove_outliers: bool = True, device="cuda"):
    """Assemble COO arrays from the map, run the two-stage LM on `device`
    and write refined poses (free keyframes) and points back into the map;
    erase outlier observations (reference src/Optimizer.cc:701-747).
    intrinsics: (fx, fy, cx, cy) as Python floats. Returns the problem's
    sizes and padded caps, or None when there was nothing to solve."""
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

    okf = padded(obs_kf, o_cap, np.int64)
    opt = padded(np.concatenate(obs_pt), o_cap, np.int64)
    ouv = padded(np.concatenate(obs_uv), (o_cap, 2), np.float32)
    ow = padded(np.concatenate(obs_w), o_cap, np.float32)
    ovalid = padded(np.ones(n_obs, bool), o_cap, bool)
    up = [torch.from_numpy(a).to(device) for a in (poses, pts, free, okf, opt, ouv, ow, ovalid)]
    new_poses, new_pts, chi2, z, _ = ba_ops.bundle_adjust_two_stage(
        *up, *intrinsics, n_iters_a=n_iters_a, n_iters_b=n_iters_b)
    outlier = ba_ops.classify_outliers(chi2, z)
    np_poses = new_poses[: len(free_kfs)].cpu().numpy()
    np_pts = new_pts[: len(pt_ids)].cpu().numpy()
    outlier = outlier[:n_obs].cpu().numpy()

    slam_map.rev += 1
    for li, kf in enumerate(free_kfs):
        if slam_map.kf_valid[kf]:
            slam_map.kf_pose[kf] = np_poses[li]
    slam_map.pt_pos[pt_ids] = np_pts
    slam_map.mark_points_dirty(pt_ids)
    if remove_outliers:
        for i in np.nonzero(outlier)[0]:
            slam_map.kf_matches[kf_list[obs_kf[i]]][obs_slot[i]] = -1
    return dict(n_kf=len(kf_list), n_pt=len(pt_ids), n_obs=n_obs, k_cap=k_cap, p_cap=p_cap,
                o_cap=o_cap, dense=ba_ops.uses_dense(k_cap, p_cap),
                n_outliers=int(outlier.sum()))


class LocalMapper:
    """Synchronous monocular local mapping over a SlamMap. intrinsics:
    (fx, fy, cx, cy) Python floats; width, height: the image size (fusion
    bounds); device: where the mapping programs run."""

    # neighbour schedules of the JAX package (targets are processed up to
    # the padded count; see _pad_sched)
    FUSE_T_SCHEDULE = (16, 32, 64, 128)
    TRI_T_SCHEDULE = (8, 20, 32)

    def __init__(self, slam_map: SlamMap, intrinsics, width: int, height: int,
                 match_th: float = 75.0, max_ba_kfs: int = 20, size_tolerance: float = 1.2,
                 device="cuda"):
        self.map = slam_map
        self.intrinsics = tuple(float(v) for v in intrinsics)
        fx, fy, cx, cy = self.intrinsics
        self.k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        self.width, self.height = int(width), int(height)
        self.match_th = match_th
        self.max_ba_kfs = max_ba_kfs
        # sizeTolerance = extractor scale factor (reference src/Frame.cc:73)
        self.size_tolerance = float(size_tolerance)
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        """Forget the recent points and the keyframe cache (a map reset)."""
        # recent points: pt_id -> keyframe count at creation (for culling)
        self.recent: dict[int, int] = {}
        self.n_kf_processed = 0
        # per-keyframe feature tensors on the device, keyed by slot and
        # guarded by uid against slot recycling
        self._dev_kf: dict[int, tuple] = {}
        self.stage_times: dict[str, list] = {}
        self.ba_log: list[dict] = []

    _DEV_FIELDS = ("uv", "bits", "size", "valid", "inv_sigma2", "angle")

    def seed_kf_device(self, kf: int, feats):
        """Adopt a new keyframe's features already on the device."""
        ent = dict(uv=feats.dev("uv_und"), bits=feats.dev("desc_bits"), size=feats.dev("size"),
                   valid=feats.dev("valid"), inv_sigma2=feats.dev("inv_sigma2"),
                   angle=feats.dev("angle"))
        self._dev_kf[int(kf)] = (int(self.map.kf_uid[kf]), ent)

    def kf_dev(self, kf: int) -> dict:
        """The keyframe's feature tensors on the device (uploaded from the
        map on first use), plus its packed descriptors (``words``)."""
        kf = int(kf)
        uid = int(self.map.kf_uid[kf])
        ent = self._dev_kf.get(kf)
        if ent is None or ent[0] != uid:
            m = self.map
            host = dict(uv=m.kf_uv[kf], bits=m.kf_desc_bits[kf], size=m.kf_size[kf],
                        valid=m.kf_feat_valid[kf], inv_sigma2=m.kf_inv_sigma2[kf],
                        angle=m.kf_angle[kf])
            ent = (uid, {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                         for k, v in host.items()})
            self._dev_kf[kf] = ent
        d = ent[1]
        if "words" not in d:
            d["words"] = cuda_match.pack_bits(d["bits"].contiguous())
        return d

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int):
        """One keyframe event, run to its end."""
        stages = self.stage_times
        t = time.perf_counter()

        def mark(name, t0):
            t1 = time.perf_counter()
            stages.setdefault(name, []).append(t1 - t0)
            return t1

        m = self.map
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
        t = mark("stats+cullpts", t)
        if m.n_keyframes() >= 2:
            self._create_new_points(kf)
            t = mark("triangulate", t)
            self._fuse(kf)
            t = mark("fuse", t)
            self._local_ba(kf)
            t = mark("local_ba", t)
        self._cull_keyframes(kf)
        mark("cullkfs", t)

    # ------------------------------------------------------------------
    def _fuse(self, kf: int):
        """Reference SearchInNeighbors (LocalMapping.cc:475-555): project the
        new keyframe's points into its first- and second-order covisible
        neighbours and theirs into it; add missing observations, merge
        duplicate points (keeping the better-observed one)."""
        m = self.map
        first, _ = m.covisible_keyframes(kf, min_weight=15, max_n=20)
        targets = []
        for n1 in first:
            targets.append(int(n1))
            second, _ = m.covisible_keyframes(int(n1), min_weight=15, max_n=5)
            targets.extend(int(x) for x in second)
        targets = [t for t in dict.fromkeys(targets) if t != kf and m.kf_valid[t]]
        if not targets:
            return
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
        ia = va = idx_a = None
        if len(pt_ids):
            idx_a = np.zeros(n, np.int64)
            idx_a[: len(pt_ids)] = pt_ids
            valid_t = np.zeros((n_t, n), bool)
            valid_t[:, : len(pt_ids)] = ~has_t[:, pt_ids]
            ga = mirror.gather(idx_a)
            ia, va = frame_ops.fuse_points_into_targets(
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
        ib, vb = frame_ops.fuse_target_points_into_kf(
            *gb[:7], torch.from_numpy(valid_b).to(dev), torch.from_numpy(m.kf_pose[kf]).to(dev),
            kf_d["uv"], kf_d["bits"], kf_d["size"], kf_d["valid"], *self.intrinsics,
            bounds_lo, bounds_hi, 3.0, self.match_th, f_words=kf_d["words"])
        if ia is not None:
            ia, va = ia.cpu().numpy(), va.cpu().numpy()
        ib, vb = ib.cpu().numpy(), vb.cpu().numpy()

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

        if ia is not None:
            for ti in range(n_t):
                for s in np.nonzero(va[ti])[0]:
                    fuse_one(targets[ti], int(idx_a[s]), int(ia[ti, s]))
        # two targets can propose the same point for this keyframe (one
        # pre-fuse snapshot); it lands on the first slot only
        kf_gained = set()
        for ti in range(n_t):
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
    def _create_new_points(self, kf: int):
        """Reference CreateNewMapPoints (LocalMapping.cc:231-473) against up
        to 20 covisible neighbours (frame_ops.triangulate_with_neighbors);
        a current-keyframe slot goes to the first (best-covisible)
        neighbour whose match passed every gate."""
        m = self.map
        neighbors, _ = m.covisible_keyframes(kf, min_weight=15, max_n=20)
        neighbors = [int(x) for x in neighbors]
        if not neighbors:
            others = [int(k) for k in m.keyframe_ids() if k != kf]
            if not others:
                return
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
            return
        keep = keep[:_pad_sched(len(keep), self.TRI_T_SCHEDULE)]
        dev = self.device
        t_arr = np.asarray(keep, np.int64)
        unmatched1 = (m.kf_matches[kf] < 0) & m.kf_feat_valid[kf]
        unmatched2 = (m.kf_matches[t_arr] < 0) & m.kf_feat_valid[t_arr]
        rows = [self.kf_dev(t) for t in keep]
        kf_d = self.kf_dev(kf)
        idx2, pts, good = frame_ops.triangulate_with_neighbors(
            kf_d["bits"], kf_d["uv"], torch.from_numpy(unmatched1).to(dev), kf_d["inv_sigma2"],
            kf_d["size"], [r["bits"] for r in rows], [r["uv"] for r in rows],
            list(torch.from_numpy(unmatched2).to(dev)), [r["size"] for r in rows],
            [r["inv_sigma2"] for r in rows], torch.from_numpy(t1).to(dev),
            torch.from_numpy(m.kf_pose[t_arr]).to(dev), torch.from_numpy(self.k).to(dev),
            self.match_th, TRI_RATIO)
        idx2, pts, good = idx2.cpu().numpy(), pts.cpu().numpy(), good.cpu().numpy()

        good = good & (m.kf_matches[kf] < 0)[None, :]
        slots1 = np.nonzero(good.any(axis=0))[0]
        if len(slots1) == 0:
            return
        first_t = np.argmax(good[:, slots1], axis=0)  # covisibility order
        slots2 = idx2[first_t, slots1]
        tgt = t_arr[first_t]
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
    def _local_ba(self, kf: int):
        """Reference LocalBundleAdjustment structure (Optimizer.cc:450-768):
        the keyframe and its covisible keyframes free; keyframes observing
        local points but not covisible fixed."""
        m = self.map
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
        info = run_bundle_adjustment(m, self.intrinsics, free, fixed, sorted(pt_ids),
                                     device=self.device)
        if info is not None:
            info["ms"] = (time.perf_counter() - t0) * 1e3
            self.ba_log.append(info)

    # ------------------------------------------------------------------
    def _cull_keyframes(self, kf: int):
        """Reference KeyFrameCulling (LocalMapping.cc:651-741): a covisible
        keyframe is redundant if > 90% of its points with > 3 observations
        are seen by >= 3 other keyframes at finer-or-equal scale."""
        m = self.map
        cov, _ = m.covisible_keyframes(kf, min_weight=15)
        counts = m.point_observation_counts(stereo_weighted=True)
        for cand in cov:
            cand = int(cand)
            if int(m.kf_uid[cand]) == 0:
                continue  # never cull the first keyframe
            mm = m.kf_matches[cand]
            slots = np.nonzero(mm >= 0)[0]
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
