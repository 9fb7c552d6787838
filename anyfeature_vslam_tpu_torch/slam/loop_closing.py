"""Loop closing: detection, Sim3 computation, loop correction and global
BA (port of anyfeature_vslam_tpu/slam/loop_closing.py).

The counterpart of the reference LoopClosing thread (reference
src/LoopClosing.cc:64-763), run inside the keyframe event:
  - DetectLoop (:119-245): BoW candidates above the minimum covisible
    score, covisibility consistency over 3 consecutive keyframes;
  - ComputeSim3 (:247-416): descriptor matches between the keyframes' map
    points (>= 20), Sim3 RANSAC (>= 20 inliers, free scale), the mutual
    SearchBySim3 round, LM refinement (>= 20) and the projection gate (>= 40
    matched points);
  - CorrectLoop (:418-599): the corrected Sim3 propagated to the current
    keyframe's covisible group, their points moved, the matched loop
    points fused, SearchAndFuse, the essential graph (ops/pose_graph.py),
    the loop edge, then global BA: run to its end inside the event, or
    issued on the mapping stream and handed to ``defer_ba_sink`` (the
    System parks it as the local mapper's pending fold); its fold corrects
    the keyframes and points created during the solve through the
    spanning tree (``_propagate_gba``, reference
    src/LoopClosing.cc:683-744).
The spanning tree is the maintained parent links plus strong covisibility
edges (weight >= 100, reference Optimizer.cc:46).

On the card every search is a K2 launch: the global descriptor match of
each Sim3 candidate, both directions of SearchBySim3, the projection gate
and SearchAndFuse's projection into each corrected keyframe. The map stays
host numpy; point rows come from the device mirror. In threaded mode the
keyframe's BoW is issued at its event and folded (database insert and
detection) at the next one (``deferred_bow``, ``flush_bow``); detection
and the Sim3 run without the map lock, which is held around ``pre_mutate``
and the correction. A Sim3 computed without the lock is applied only if
both keyframes are still the ones it was computed for.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import perfcount
from ..ops import pose_graph
from ..ops import sim3 as sim3_ops
from . import frame_ops
from .local_mapping import run_bundle_adjustment

MIN_BOW_MATCHES = 20      # reference LoopClosing.cc:283
MIN_SIM3_INLIERS = 20     # reference LoopClosing.cc:345
MIN_TOTAL_MATCHES = 40    # reference LoopClosing.cc:401 (projection gate)
CONSISTENCY_TH = 3        # reference LoopClosing.cc:46
COVIS_EDGE_MIN_WEIGHT = 100  # reference Optimizer.cc:46 (minFeat)
SIM3_SEARCH_RADIUS = 7.5  # reference LoopClosing.cc:324 (SearchBySim3 th)
PROJ_GATE_RADIUS = 10.0   # reference LoopClosing.cc:393 (SearchByProjection th)
FUSE_RADIUS = 4.0         # reference LoopClosing.cc:617 (SearchAndFuse th)


def _pad_pairs(arrays, n, schedule=(64, 256, 1024)):
    """Pad per-pair arrays to the JAX package's buckets, with a valid mask.
    The RANSAC draws are uniform(seed, (200, padded n)), so the padding
    must be the JAX package's for both to draw the same subsets."""
    cap = schedule[-1]
    for c in schedule:
        if n <= c:
            cap = c
            break
    while cap < n:
        cap *= 2
    out = []
    for a in arrays:
        pad = np.zeros((cap,) + a.shape[1:], a.dtype)
        pad[:n] = a
        out.append(pad)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return out, valid


class LoopCloser:
    """Synchronous loop closing over a SlamMap. cam: anything with fx, fy,
    cx, cy, width, height (numbers or 0-d tensors); database: the
    KeyFrameDatabase; kf_dev: optional keyframe -> feature tensors on the
    device with prepared descriptors (``LocalMapper.kf_dev``), else each
    keyframe's features are uploaded from the map when searched; mesh: a
    parallel/sharded_ba.Mesh over which the global BA runs sharded."""

    def __init__(self, slam_map, cam, database, match_th: float = 75.0, seed: int = 0,
                 device="cuda", kf_dev=None, lock=None, mesh=None):
        self.map = slam_map
        self.mesh = mesh
        self.intrinsics = tuple(float(getattr(cam, k)) for k in ("fx", "fy", "cx", "cy"))
        self.width, self.height = int(cam.width), int(cam.height)
        self.db = database
        self.match_th = match_th
        self.seed = seed
        self.device = torch.device(device)
        self.kf_dev = kf_dev
        self.consistent_groups: list[tuple[set, int]] = []
        self._pending_merge = None
        self._loop_points = None
        self.last_loop_kf = -1000
        self.n_loops_closed = 0
        # gba_log: run_bundle_adjustment's sizes, caps and solver of each
        # global BA, with its ms and the keyframe poses it started from
        # ("kf_pose_in")
        self.gba_log: list[dict] = []
        # the System's map lock (a private one otherwise): held around
        # pre_mutate and the correction only
        self.lock = lock if lock is not None else threading.RLock()
        # threaded mode: BoW issued at a keyframe's event, folded at the next
        self.deferred_bow = False
        self._pending_bow = None
        # when set, the global BA is issued (on `stream`) and its fold handed
        # to this sink instead of being waited on
        self.defer_ba_sink = None
        self.stream = None

    def _to_dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _kf_feats(self, kf: int) -> dict:
        """uv, bits, size, valid, angle (and words, when cached) of a
        keyframe on the device."""
        if self.kf_dev is not None:
            return self.kf_dev(kf)
        m = self.map
        return dict(uv=self._to_dev(m.kf_uv[kf]), bits=self._to_dev(m.kf_desc_bits[kf]),
                    size=self._to_dev(m.kf_size[kf]), valid=self._to_dev(m.kf_feat_valid[kf]),
                    angle=self._to_dev(m.kf_angle[kf]))

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int, pre_mutate=None) -> bool:
        """Detection at a new keyframe, and the correction when a candidate
        passes every gate. Returns True if a loop was closed. pre_mutate:
        called under the lock before the first Sim3 reads poses and points
        (lands a deferred local-BA fold; the reference stops local mapping
        before CorrectLoop, src/LoopClosing.cc:424-445).

        With deferred_bow the keyframe's BoW is issued here and folded at
        the next call, which then runs the previous keyframe's detection
        (one keyframe of latency, the reference's LoopClosing queue's
        class, src/LoopClosing.cc:106-111). Otherwise the BoW is computed
        once and shared by detection and the database insert."""
        if self.deferred_bow:
            closed = False
            prev, self._pending_bow = self._pending_bow, None
            if prev is not None:
                pkf, puid, ready = prev
                if self.map.kf_valid[pkf] and int(self.map.kf_uid[pkf]) == puid:
                    closed = self._process_with_bow(
                        pkf, self.db.bow_from_words(ready.host()[0]), pre_mutate)
            with perfcount.span("loop.bow"):
                self._pending_bow = (kf, int(self.map.kf_uid[kf]),
                                     self.db.dispatch_bow(*self._bits(kf)))
            return closed
        with perfcount.span("loop.bow"):
            bow = self.db.compute_bow(*self._bits(kf))
        return self._process_with_bow(kf, bow, pre_mutate)

    def _bits(self, kf: int):
        """The keyframe's descriptors and validity (device tensors when the
        keyframe cache is wired)."""
        if self.kf_dev is not None:
            f = self.kf_dev(kf)
            return f["bits"], f["valid"]
        return self.map.kf_desc_bits[kf], self.map.kf_feat_valid[kf]

    def flush_bow(self):
        """Land a deferred BoW (the database insert only, no detection) so a
        shutdown or a checkpoint leaves the database complete."""
        prev, self._pending_bow = self._pending_bow, None
        if prev is not None:
            pkf, puid, ready = prev
            if self.map.kf_valid[pkf] and int(self.map.kf_uid[pkf]) == puid:
                self.db.add(pkf, bow=self.db.bow_from_words(ready.host()[0]))

    def _process_with_bow(self, kf: int, bow, pre_mutate=None) -> bool:
        m = self.map
        closed = False
        uid = int(m.kf_uid[kf])
        # >= 10 keyframes since the last closure (reference
        # LoopClosing.cc:128), by stable uid (slots recycle)
        if m.n_keyframes() > 10 and uid - self.last_loop_kf > 10:
            with perfcount.span("loop.detect"):
                candidates = self._detect_loop(kf, bow)
            if candidates and pre_mutate is not None:
                with self.lock:
                    pre_mutate()
            for cand in candidates:
                cand_uid = int(m.kf_uid[cand])
                with perfcount.span("loop.sim3"):
                    ok, r, tr, s = self._compute_sim3(kf, cand)
                if ok:
                    # a correction stops the world (LoopClosing.cc:424-445);
                    # the Sim3 was computed without the lock, so it applies
                    # only to the keyframes it was computed for
                    with self.lock:
                        still = (m.kf_valid[kf] and int(m.kf_uid[kf]) == uid
                                 and m.kf_valid[cand] and int(m.kf_uid[cand]) == cand_uid)
                        if still:
                            self._correct_loop(kf, cand, r, tr, s)
                    if not still:
                        self._pending_merge = self._loop_points = None
                        break
                    self.last_loop_kf = uid
                    self.n_loops_closed += 1
                    closed = True
                    break
        self.db.add(kf, bow=bow)
        return closed

    # ------------------------------------------------------------------
    def _detect_loop(self, kf: int, bow=None):
        min_score = self.db.min_score_vs_covisibles(kf, self.map, bow_q=bow)
        candidates = [c for c in self.db.detect_loop_candidates(kf, self.map, min_score, bow_q=bow)
                      if self.map.kf_valid[c]]
        if not candidates:
            self.consistent_groups = []
            return []
        # covisibility consistency over consecutive keyframes
        enough = []
        new_groups = []
        for cand in candidates:
            cov, _ = self.map.covisible_keyframes(cand, min_weight=15)
            group = set([cand] + [int(c) for c in cov])
            matched = False
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    new_groups.append((group, count + 1))
                    if count + 1 >= CONSISTENCY_TH:
                        enough.append(cand)
                    matched = True
                    break
            if not matched:
                new_groups.append((group, 1))
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------
    def _pairs(self, kf, cand, sl1, sl2):
        """Camera-frame points, keypoints and sigma^2 of matched slot pairs."""
        m = self.map
        t1, t2 = m.kf_pose[kf], m.kf_pose[cand]
        pc1 = m.pt_pos[m.kf_matches[kf][sl1]] @ t1[:3, :3].T + t1[:3, 3]
        pc2 = m.pt_pos[m.kf_matches[cand][sl2]] @ t2[:3, :3].T + t2[:3, 3]
        s2_1 = 1.0 / np.clip(m.kf_inv_sigma2[kf][sl1], 1e-9, None)
        s2_2 = 1.0 / np.clip(m.kf_inv_sigma2[cand][sl2], 1e-9, None)
        return pc1, pc2, m.kf_uv[kf][sl1], m.kf_uv[cand][sl2], s2_1, s2_2

    def _compute_sim3(self, kf: int, cand: int):
        m = self.map
        has1 = (m.kf_matches[kf] >= 0) & m.kf_feat_valid[kf]
        has2 = (m.kf_matches[cand] >= 0) & m.kf_feat_valid[cand]
        f1, f2 = self._kf_feats(kf), self._kf_feats(cand)
        # ratio 0.9, not the reference's 0.75: the reference's SearchByBoW
        # takes best/second inside one BoW node, the dense search's second
        # best is global and on self-similar scenes much closer to the best
        res = frame_ops.match_descriptors_global(
            f1["bits"], self._to_dev(has1), f1["angle"], f2["bits"], self._to_dev(has2),
            f2["angle"], self.match_th, 0.9, f2.get("words"))
        res = {k: v.cpu().numpy() for k, v in res.items()}
        sl1 = np.nonzero(res["valid"])[0]
        if len(sl1) < MIN_BOW_MATCHES:
            return False, None, None, None
        sl2 = res["idx"][sl1]
        fx, fy, cx, cy = self.intrinsics
        pc1, pc2, uv1, uv2, s2_1, s2_2 = self._pairs(kf, cand, sl1, sl2)
        padded, vmask = _pad_pairs([a.astype(np.float32) for a in
                                    (pc1, pc2, uv1, uv2, s2_1, s2_2)], len(sl1))
        out = sim3_ops.sim3_ransac(*(self._to_dev(a) for a in padded), self._to_dev(vmask),
                                   fx, fy, cx, cy, self.seed, fix_scale=False)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if int(out["n_inliers"]) < MIN_SIM3_INLIERS:
            return False, None, None, None

        # mutual SearchBySim3 round (reference LoopClosing.cc:324-333,
        # src/FeatureMatcher.cc:1066-1289): new agreeing correspondences
        add1, add2 = self._search_by_sim3(kf, cand, out["r"], out["t"], float(out["s"]),
                                          np.stack([sl1, sl2], axis=1))
        if len(add1):
            sl1 = np.concatenate([sl1, add1])
            sl2 = np.concatenate([sl2, add2])
            pc1, pc2, uv1, uv2, s2_1, s2_2 = self._pairs(kf, cand, sl1, sl2)
        n = len(sl1)

        # LM refinement over all pairs (reference OptimizeSim3 with th2 = 10,
        # accepted at >= 20 inliers, LoopClosing.cc:352-359)
        padded, vmask = _pad_pairs([a.astype(np.float32) for a in
                                    (pc1, pc2, uv1, uv2, 1.0 / s2_1, 1.0 / s2_2)], n)
        ref = sim3_ops.sim3_optimize(out["r"], out["t"], float(out["s"]),
                                     *(self._to_dev(a) for a in padded), self._to_dev(vmask),
                                     fx, fy, cx, cy)
        ref = {k: v.cpu().numpy() for k, v in ref.items()}
        if int(ref["n_inliers"]) < MIN_SIM3_INLIERS:
            return False, None, None, None

        # the projection gate (reference LoopClosing.cc:365-401): the loop
        # neighbourhood's points (cand + its covisibles) projected into kf
        # with the refined S_cw; at least 40 distinct matched points
        cov, _ = m.covisible_keyframes(cand, min_weight=15)
        loop_kfs = [cand] + [int(c) for c in cov]
        loop_pts = np.unique(np.concatenate([m.kf_matches[i][m.kf_matches[i] >= 0]
                                             for i in loop_kfs]))
        loop_pts = loop_pts[m.pt_valid[loop_pts]].astype(np.int64)
        t2 = m.kf_pose[cand]
        s_mw = (t2[:3, :3], t2[:3, 3], np.float32(1.0))
        s_cw = _compose((np.asarray(ref["r"], np.float32), np.asarray(ref["t"], np.float32),
                         np.float32(ref["s"])), s_mw)
        slots_gate, pts_gate = self._project_loop_points(kf, loop_pts, s_cw, PROJ_GATE_RADIUS)
        inl = np.asarray(ref["inliers"])[:n]
        pt2 = m.kf_matches[cand][sl2]
        matched = dict(zip(sl1[inl].tolist(), pt2[inl].tolist()))
        for s_, p_ in zip(slots_gate.tolist(), pts_gate.tolist()):
            matched.setdefault(s_, p_)
        if len(matched) < MIN_TOTAL_MATCHES:
            return False, None, None, None
        # matched loop point pairs, fused after the pose correction
        # (reference CorrectLoop order :533-556), and the loop points for
        # SearchAndFuse
        self._pending_merge = (np.asarray(list(matched.keys()), np.int64),
                               np.asarray(list(matched.values()), np.int64))
        self._loop_points = loop_pts
        return True, ref["r"], ref["t"], float(ref["s"])

    # ------------------------------------------------------------------
    def _project_sim3(self, pt_ids, s_cw):
        """uv, predicted size and visibility of world points under a Sim3
        world -> camera map (reference SearchByProjection(KF, Scw, ...)
        geometry, src/FeatureMatcher.cc:300-360). Host numpy."""
        m = self.map
        fx, fy, cx, cy = self.intrinsics
        r, t, s = s_cw
        x = m.pt_pos[pt_ids]
        pc = s * (x @ r.T) + t
        z = pc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        u = fx * pc[:, 0] / zs + cx
        v = fy * pc[:, 1] / zs + cy
        uv = np.stack([u, v], axis=-1).astype(np.float32)
        ow = (-(r.T @ t) / s).astype(np.float32)
        po = x - ow
        dist = np.linalg.norm(po, axis=-1)
        nrm = np.linalg.norm(m.pt_normal[pt_ids], axis=-1)
        viewcos = (po * m.pt_normal[pt_ids]).sum(-1) / np.clip(dist * nrm, 1e-9, None)
        visible = ((z > 0) & (u >= 0) & (u < self.width) & (v >= 0) & (v < self.height)
                   & (dist >= m.pt_min_dist[pt_ids]) & (dist <= m.pt_max_dist[pt_ids])
                   & (viewcos > 0.5))
        pred_size = (m.pt_ref_size[pt_ids] * m.pt_ref_dist[pt_ids]
                     / np.clip(dist, 1e-9, None)).astype(np.float32)
        return uv, pred_size, visible

    def _project_loop_points(self, kf: int, pt_ids, s_cw, radius):
        """Match world points into kf's keypoints under the Sim3 s_cw (one
        K2 launch). Returns (kf slots, point ids) of the accepted matches."""
        m = self.map
        if len(pt_ids) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        bucket = 256
        while bucket < len(pt_ids):
            bucket *= 2
        idx = np.concatenate([pt_ids, np.zeros(bucket - len(pt_ids), np.int64)])
        uv, pred, vis = self._project_sim3(idx, s_cw)
        vis[len(pt_ids):] = False
        desc = m.mirror().gather(idx)[6]  # descriptors gathered on the device
        f = self._kf_feats(kf)
        res = frame_ops.match_loop_projection(
            self._to_dev(uv), self._to_dev(pred), desc, self._to_dev(vis), f["uv"], f["bits"],
            f["size"], f["valid"], float(radius), self.match_th, f.get("words"))
        res = {k: v.cpu().numpy() for k, v in res.items()}
        src = np.nonzero(res["valid"])[0]
        return res["idx"][src].astype(np.int64), idx[src]

    def _search_by_sim3(self, kf: int, cand: int, r, t, s, pairs):
        """Mutual Sim3-guided search (reference SearchBySim3,
        src/FeatureMatcher.cc:1066-1289): cand's points into kf and kf's
        points into cand; keep the new correspondences both directions
        agree on. Returns (new kf slots, new cand slots)."""
        m = self.map
        r = np.asarray(r, np.float32)
        t = np.asarray(t, np.float32)
        t1, t2 = m.kf_pose[kf], m.kf_pose[cand]
        s_cm = (r, t, np.float32(s))
        s_cw = _compose(s_cm, (t2[:3, :3], t2[:3, 3], np.float32(1.0)))
        s_mw_from_c = _compose(_inv(s_cm), (t1[:3, :3], t1[:3, 3], np.float32(1.0)))
        used1 = set(pairs[:, 0].tolist())
        used2 = set(pairs[:, 1].tolist())
        m2 = m.kf_matches[cand]
        pts2 = np.unique(m2[m2 >= 0])
        pts2 = pts2[m.pt_valid[pts2]].astype(np.int64)
        m1 = m.kf_matches[kf]
        pts1 = np.unique(m1[m1 >= 0])
        pts1 = pts1[m.pt_valid[pts1]].astype(np.int64)
        slots_in_kf, pts2_matched = self._project_loop_points(kf, pts2, s_cw, SIM3_SEARCH_RADIUS)
        slots_in_cand, pts1_matched = self._project_loop_points(cand, pts1, s_mw_from_c,
                                                                SIM3_SEARCH_RADIUS)
        cand_slot_of_p1 = dict(zip(pts1_matched.tolist(), slots_in_cand.tolist()))
        new1, new2 = [], []
        for sl_kf, p2 in zip(slots_in_kf.tolist(), pts2_matched.tolist()):
            p1 = int(m.kf_matches[kf][sl_kf])
            if p1 < 0 or sl_kf in used1:
                continue
            sl_cand = cand_slot_of_p1.get(p1)
            if sl_cand is None or sl_cand in used2 or int(m2[sl_cand]) != int(p2):
                continue
            new1.append(sl_kf)
            new2.append(sl_cand)
            used1.add(sl_kf)
            used2.add(sl_cand)
        return np.asarray(new1, np.int64), np.asarray(new2, np.int64)

    # ------------------------------------------------------------------
    def _merge_into(self, kf: int, slots, pts):
        """The loop point replaces the keyframe's point at the slot, or
        becomes a new observation on an empty slot (reference
        LoopClosing.cc:533-556, Fuse with replace)."""
        m = self.map
        keep, drop = [], []
        for sl, lp in zip(slots.tolist(), pts.tolist()):
            lp = int(lp)
            if not m.pt_valid[lp]:
                continue
            existing = int(m.kf_matches[kf][sl])
            if existing == lp:
                continue
            if existing >= 0:
                keep.append(lp)
                drop.append(existing)
            else:
                m.kf_matches[kf][sl] = lp
        if keep:
            m.merge_points(keep, drop)

    def _correct_loop(self, kf: int, cand: int, r, t, s):
        """Apply S_cm (cand-camera -> kf-camera coordinates). Reference
        CorrectLoop order (LoopClosing.cc:418-599): correct the covisible
        group's poses and points, fuse the matched loop points, optimize the
        essential graph with the pre-correction poses as the structural
        measurements, add the loop edge, then global BA."""
        m = self.map
        with perfcount.span("loop.correct"):
            r = np.asarray(r, np.float32)
            t = np.asarray(t, np.float32)
            pre_poses = m.kf_pose.copy()
            t_mw = m.kf_pose[cand]
            s_cw_corr = _compose((r, t, np.float32(s)),
                                 (t_mw[:3, :3], t_mw[:3, 3], np.float32(1.0)))
            cov, _ = m.covisible_keyframes(kf, min_weight=15)
            group = [kf] + [int(c) for c in cov]
            t_cw_old = m.kf_pose[kf]
            corrected = {}
            for i in group:
                t_ic = m.kf_pose[i] @ np.linalg.inv(t_cw_old)  # S_ic = T_iw T_cw^-1
                corrected[i] = _compose((t_ic[:3, :3], t_ic[:3, 3], np.float32(1.0)), s_cw_corr)
            # the group's points, each once: p' = S_corr^-1(S_old(p))
            done = set()
            for i in group:
                mm = m.kf_matches[i]
                pts = [p for p in np.unique(mm[mm >= 0]) if p not in done]
                done.update(pts)
                if not pts:
                    continue
                pts = np.asarray(pts)
                t_iw_old = m.kf_pose[i]
                x_cam = _apply((t_iw_old[:3, :3], t_iw_old[:3, 3], np.float32(1.0)), m.pt_pos[pts])
                m.pt_pos[pts] = _apply(_inv(corrected[i]), x_cam)
                m.mark_points_dirty(pts)
            # corrected SE3 poses: T = [R, t / s]
            for i, (ri, ti, si) in corrected.items():
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = ri
                pose[:3, 3] = ti / si
                m.kf_pose[i] = pose
            if self._pending_merge is not None:
                self._merge_into(kf, *self._pending_merge)
                self._pending_merge = None
        with perfcount.span("loop.fuse"):
            # SearchAndFuse (reference LoopClosing.cc:601-627)
            self._search_and_fuse(corrected)
            m.update_point_stats()
        with perfcount.span("loop.essential_graph"):
            self._optimize_essential_graph(kf, cand, pre_poses)
            # the loop edge, for every later essential graph (reference
            # KeyFrame::AddLoopEdge, LoopClosing.cc:577-579)
            m.loop_edges.append((int(m.kf_uid[kf]), int(m.kf_uid[cand])))
        t0 = time.perf_counter()
        with perfcount.span("loop.global_ba"):
            # global BA over every keyframe, the oldest fixed (reference
            # RunGlobalBundleAdjustment); with a sink, issued and folded later
            kf_ids = [int(k) for k in m.keyframe_ids()]
            fixed = [min(kf_ids)]
            free = [k for k in kf_ids if k not in fixed]
            pose_in = m.kf_pose.copy()
            pt_ids = np.nonzero(m.pt_valid)[0]
            defer = self.defer_ba_sink is not None
            res = run_bundle_adjustment(m, self.intrinsics, free, fixed, pt_ids, n_iters_a=5,
                                        n_iters_b=10, device=self.device, defer=defer,
                                        stream=self.stream, mesh=self.mesh)
            if defer and res is not None:
                # solve membership by identity: the fold tells keyframes and
                # points created during the solve apart from its members
                uid_in_solve = {int(m.kf_uid[k]) for k in kf_ids}
                pt_in_solve = np.zeros(m.max_pt, bool)
                pt_in_solve[pt_ids] = True

                def gba_fold(f=res):
                    pre_poses = m.kf_pose.copy()
                    f()
                    self._propagate_gba(uid_in_solve, pt_in_solve, pre_poses)
                    m.update_point_stats()
                    m.inform_big_change()

                gba_fold.ready = res.ready
                info = res.info
                self.defer_ba_sink(gba_fold)
            else:
                info = res
                m.update_point_stats()
                m.inform_big_change()
        t1 = time.perf_counter()
        if info is not None:
            info["ms"] = (t1 - t0) * 1e3
            info["deferred"] = defer
            info["kf_pose_in"] = pose_in
            self.gba_log.append(info)

    def _propagate_gba(self, uid_in_solve: set, pt_in_solve, pre_poses):
        """Correct the keyframes and points created while the deferred
        global BA ran (reference RunGlobalBundleAdjustment propagation,
        src/LoopClosing.cc:683-744): keyframes walk the spanning tree from
        their corrected parents, Tcw_child = (Tcw_child_old Tcw_parent_old^-1)
        Tcw_parent_new; points outside the solve follow their reference
        keyframe, p' = T_ref_new^-1 (T_ref_old (p)). pre_poses: every
        keyframe's pose just before the fold wrote the solve's results."""
        m = self.map
        pending = {int(s) for s in m.keyframe_ids() if int(m.kf_uid[s]) not in uid_in_solve}
        # children of corrected keyframes first (keyframe culling can give a
        # child a parent of larger uid, so uid order alone is not enough)
        progress = True
        while pending and progress:
            progress = False
            for s in sorted(pending, key=lambda x: int(m.kf_uid[x])):
                p = int(m.kf_parent[s])
                if p < 0 or not m.kf_valid[p] or p == s:
                    pending.discard(s)  # rootless: nothing to anchor to
                    progress = True
                    break
                if p in pending:
                    continue  # parent not corrected yet
                t_rel = pre_poses[s] @ np.linalg.inv(pre_poses[p])
                m.kf_pose[s] = (t_rel @ m.kf_pose[p]).astype(np.float32)
                pending.discard(s)
                progress = True
                break
        # parent cycles among mid-solve keyframes: uid order
        for s in sorted(pending, key=lambda x: int(m.kf_uid[x])):
            p = int(m.kf_parent[s])
            if p < 0 or not m.kf_valid[p] or p == s:
                continue
            t_rel = pre_poses[s] @ np.linalg.inv(pre_poses[p])
            m.kf_pose[s] = (t_rel @ m.kf_pose[p]).astype(np.float32)
        # mid-solve points: valid now, absent from the solve
        is_new = m.pt_valid.copy()
        k = min(len(is_new), len(pt_in_solve))
        is_new[:k] &= ~pt_in_solve[:k]
        ids = np.nonzero(is_new)[0]
        if len(ids) == 0:
            return
        refs = m.pt_ref_kf[ids]
        ok = (refs >= 0) & m.kf_valid[np.maximum(refs, 0)]
        ids, refs = ids[ok], refs[ok]
        for r in np.unique(refs):
            sel = ids[refs == r]
            t_old, t_new = pre_poses[r], m.kf_pose[r]
            x_cam = m.pt_pos[sel] @ t_old[:3, :3].T + t_old[:3, 3]
            m.pt_pos[sel] = ((x_cam - t_new[:3, 3]) @ t_new[:3, :3]).astype(np.float32)
            m.mark_points_dirty(sel)

    def _search_and_fuse(self, corrected: dict):
        """Project every loop-side point into each corrected keyframe
        (radius 4) and fuse duplicates, the loop point replacing the
        keyframe's (reference SearchAndFuse, src/LoopClosing.cc:601-627)."""
        m = self.map
        loop_pts = self._loop_points
        self._loop_points = None
        if loop_pts is None or len(loop_pts) == 0:
            return
        loop_pts = loop_pts[m.pt_valid[loop_pts]]
        for i, s_iw in corrected.items():
            if not m.kf_valid[i] or len(loop_pts) == 0:
                continue
            slots, pts = self._project_loop_points(i, loop_pts, s_iw, FUSE_RADIUS)
            self._merge_into(i, slots, pts)
            # forwarded merges can invalidate later loop points
            loop_pts = loop_pts[m.pt_valid[loop_pts]]

    def _optimize_essential_graph(self, kf: int, cand: int, pre_poses):
        m = self.map
        kf_ids = sorted(int(k) for k in m.keyframe_ids())
        if len(kf_ids) < 3:
            return
        k_cap = m.max_kf
        # vertex initial values: the current (post-correction) poses
        r_all = np.tile(np.eye(3, dtype=np.float32), (k_cap, 1, 1))
        t_all = np.zeros((k_cap, 3), np.float32)
        s_all = np.ones(k_cap, np.float32)
        for i in kf_ids:
            r_all[i] = m.kf_pose[i][:3, :3]
            t_all[i] = m.kf_pose[i][:3, 3]
        edges = []
        seen_pairs = set()

        def add_edge(i, j, poses, w=1.0):
            """Measurement S_ij from the given pose snapshot."""
            key = frozenset((i, j))
            if key in seen_pairs or i == j:
                return
            seen_pairs.add(key)
            si = (poses[i][:3, :3], poses[i][:3, 3], np.float32(1.0))
            sj = (poses[j][:3, :3], poses[j][:3, 3], np.float32(1.0))
            edges.append((i, j, _compose(si, _inv(sj)), w))

        # the loop edge from the corrected poses (first, so the structural
        # duplicate of the pair is skipped), then every earlier loop edge
        # (reference Optimizer.cc:914-927)
        add_edge(kf, cand, m.kf_pose, w=1.0)
        for ua, ub in m.loop_edges:
            a, b = m.uid_slot.get(int(ua)), m.uid_slot.get(int(ub))
            if a is not None and b is not None and m.kf_valid[a] and m.kf_valid[b]:
                add_edge(int(a), int(b), pre_poses)
        # structural edges from the pre-correction poses (reference
        # NonCorrectedSim3, Optimizer.cc:850-960): spanning tree, a chain
        # for parentless keyframes, strong covisibility
        for i in kf_ids:
            p = int(m.kf_parent[i])
            if p >= 0 and m.kf_valid[p]:
                add_edge(i, p, pre_poses)
        for a, b in zip(kf_ids[1:], kf_ids[:-1]):
            if int(m.kf_parent[a]) < 0:
                add_edge(a, b, pre_poses)
        for i in kf_ids:
            w = m.covisibility_weights(i)
            for j in np.nonzero(w >= COVIS_EDGE_MIN_WEIGHT)[0]:
                if j > i:
                    add_edge(int(j), int(i), pre_poses)

        # edges padded to the JAX package's buckets
        e = len(edges)
        e_cap = 64
        while e_cap < e:
            e_cap *= 4
        ei = np.zeros(e_cap, np.int64)
        ej = np.zeros(e_cap, np.int64)
        er = np.tile(np.eye(3, dtype=np.float32), (e_cap, 1, 1))
        et = np.zeros((e_cap, 3), np.float32)
        es = np.ones(e_cap, np.float32)
        ew = np.zeros(e_cap, np.float32)
        evalid = np.zeros(e_cap, bool)
        ei[:e] = [x[0] for x in edges]
        ej[:e] = [x[1] for x in edges]
        er[:e] = np.stack([x[2][0] for x in edges]).astype(np.float32)
        et[:e] = np.stack([x[2][1] for x in edges]).astype(np.float32)
        es[:e] = [x[2][2] for x in edges]
        ew[:e] = [x[3] for x in edges]
        evalid[:e] = True
        valid = np.zeros(k_cap, bool)
        valid[kf_ids] = True
        fixed = np.zeros(k_cap, bool)
        fixed[cand] = True  # reference fixes the loop keyframe (Optimizer.cc:818)
        r2, t2, s2 = pose_graph.optimize_pose_graph(
            *(self._to_dev(a) for a in (r_all, t_all, s_all, valid, fixed, ei, ej, er, et, es,
                                        ew, evalid)))
        r2, t2, s2 = r2.cpu().numpy(), t2.cpu().numpy(), s2.cpu().numpy()
        # points follow their reference keyframe's Sim3 pair (reference
        # Optimizer.cc:985-1026): p' = S_new^-1(S_old(p))
        for i in kf_ids:
            mm = m.kf_matches[i]
            pts = np.unique(mm[mm >= 0])
            pts = pts[m.pt_ref_kf[pts] == i] if len(pts) else pts
            if len(pts):
                x_cam = _apply((r_all[i], t_all[i], s_all[i]), m.pt_pos[pts])
                m.pt_pos[pts] = _apply(_inv((r2[i], t2[i], s2[i])), x_cam)
                m.mark_points_dirty(pts)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = r2[i]
            pose[:3, 3] = t2[i] / s2[i]
            m.kf_pose[i] = pose


# ---------------------------------------------------------------- helpers
def _compose(a, b):
    ra, ta, sa = a
    rb, tb, sb = b
    return ((ra @ rb).astype(np.float32), (sa * (ra @ tb) + ta).astype(np.float32),
            np.float32(sa * sb))


def _inv(a):
    r, t, s = a
    ri = r.T
    si = 1.0 / s
    return ri.astype(np.float32), (-si * (ri @ t)).astype(np.float32), np.float32(si)


def _apply(a, pts):
    r, t, s = a
    return (s * (pts @ r.T) + t).astype(np.float32)
