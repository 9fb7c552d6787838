"""Fixed-capacity structure-of-arrays SLAM map (port of
anyfeature_vslam_tpu/slam/map_state.py).

Replaces the reference's pointer graph (Map / KeyFrame / MapPoint /
Observation, reference include/Map.h, KeyFrame.h, MapPoint.h) with plain
numpy arrays + free-lists on the host. Keyframe -> map-point association is
the per-keyframe ``kf_matches`` array (keypoint slot -> point id or -1),
from which observations, covisibility and BA COO arrays are derived.

Host arrays, as in the JAX package; what consumers need on the device they
gather through ``mirror()`` (slam/device_map.py). Observation counts,
covisibility weights and point statistics run in the host library
(``native.py``, csrc/slam_native.cpp) where the JAX package runs its
native kernels; the stereo-weighted count stays numpy, as there.
Checkpoints (``save``/``load``) write and read the JAX package's file
format: a map saved by either package loads in the other.
"""

from __future__ import annotations

import ast

import numpy as np

from .. import native


class SlamMap:
    def __init__(
        self, max_kf: int = 512, max_pt: int = 60000, n_feat: int = 1024,
        desc_dim: int = 256, desc_dtype=np.uint8, device="cuda",
    ):
        self.max_kf = max_kf
        self.max_pt = max_pt
        self.n_feat = n_feat
        self.desc_dim = desc_dim
        self.desc_dtype = desc_dtype
        # where the point mirror lives (slam/device_map.py)
        self.device = device

        k, p, n = max_kf, max_pt, n_feat
        self.kf_valid = np.zeros(k, bool)
        # frames anchor to a stable keyframe IDENTITY (uid), not a slot;
        # culled keyframes retire into `retired_kfs` with their pose
        # relative to a surviving parent (reference KeyFrame::SetBadFlag,
        # src/KeyFrame.cc:492-588)
        self.kf_uid = np.full(k, -1, np.int64)
        self._uid_counter = 0
        self.uid_slot: dict = {}       # live uid -> slot
        self.retired_kfs: dict = {}    # uid -> (t_cp 4x4 f32, parent uid)
        self.kf_pose = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))  # Tcw
        # covisibility spanning tree: parent slot per keyframe (-1 = root)
        self.kf_parent = np.full(k, -1, np.int32)
        # accepted loop-closure edges as (uid, uid) pairs: every later
        # essential-graph solve includes all of them (reference
        # Optimizer.cc:914-915 via KeyFrame::GetLoopEdges)
        self.loop_edges: list[tuple[int, int]] = []
        self.kf_ts = np.zeros(k, np.float64)
        self.kf_frame_id = np.full(k, -1, np.int64)
        self.kf_matches = np.full((k, n), -1, np.int32)  # keypoint -> point id
        # per-KF feature snapshots (set at insertion)
        self.kf_uv = np.zeros((k, n, 2), np.float32)  # undistorted coords
        self.kf_desc_bits = np.zeros((k, n, desc_dim), desc_dtype)
        self.kf_octave = np.zeros((k, n), np.int32)
        self.kf_size = np.ones((k, n), np.float32)
        self.kf_angle = np.zeros((k, n), np.float32)
        self.kf_inv_sigma2 = np.ones((k, n), np.float32)
        self.kf_feat_valid = np.zeros((k, n), bool)
        # sensor depth per keypoint (-1 = none); a depth-bearing observation
        # counts double in the stereo-weighted tallies
        self.kf_depth = np.full((k, n), -1.0, np.float32)

        self.pt_valid = np.zeros(p, bool)
        self.pt_pos = np.zeros((p, 3), np.float32)
        self.pt_desc_bits = np.zeros((p, desc_dim), desc_dtype)
        self.pt_normal = np.zeros((p, 3), np.float32)
        self.pt_min_dist = np.zeros(p, np.float32)
        self.pt_max_dist = np.zeros(p, np.float32)
        self.pt_ref_kf = np.full(p, -1, np.int32)
        self.pt_ref_size = np.ones(p, np.float32)
        self.pt_ref_dist = np.ones(p, np.float32)
        self.pt_first_kf = np.full(p, -1, np.int32)
        self.pt_visible = np.zeros(p, np.int32)
        self.pt_found = np.zeros(p, np.int32)
        # fusion forwarding: dropped point -> surviving point (reference
        # MapPoint::GetReplaced)
        self.pt_replaced = np.full(p, -1, np.int32)
        # rev at which a slot was last freed: freed slots are quarantined
        # for a window of revisions before reuse
        self.pt_freed_rev = np.full(p, -(10 ** 9), np.int64)

        # called with the slot of every culled keyframe (System wires the
        # keyframe database's erase: reference KeyFrame::SetBadFlag ->
        # KeyFrameDatabase::erase)
        self.on_kf_removed = None
        self._next_kf = 0
        self._next_pt = 0
        # big-change counter (reference Map::InformNewBigChange, read by
        # System.map_changed)
        self.change_idx = 0
        # bumped on any mutation of point/keyframe geometry or structure;
        # device-side caches key on it
        self.rev = 0
        self._obs_counts_cache = None
        # rows changed since the device mirror's last sync (marked after
        # the write)
        self.pt_dirty = np.zeros(p, bool)
        self._mirror = None

    def mirror(self):
        """The lazily-created point mirror on ``self.device``."""
        if self._mirror is None:
            from .device_map import DevicePointMirror

            self._mirror = DevicePointMirror(self, self.device)
        return self._mirror

    def mark_points_dirty(self, ids):
        """Record that these points' SoA rows changed (call after the
        write)."""
        self.pt_dirty[ids] = True

    # ---------------------------------------------------------- checkpoint
    _SCALARS = ("max_kf", "max_pt", "n_feat", "desc_dim", "_next_kf", "_next_pt",
                "_uid_counter")

    def save(self, path: str):
        """The whole map in the JAX package's checkpoint format: every numpy
        array attribute, the retired-keyframe anchors, the loop edges and
        the scalar metadata, in one compressed .npz."""
        arrays = {k: v for k, v in self.__dict__.items() if isinstance(v, np.ndarray)}
        ruids = sorted(self.retired_kfs)
        arrays["__ret_uid__"] = np.asarray(ruids, np.int64)
        arrays["__ret_parent__"] = np.asarray([self.retired_kfs[u][1] for u in ruids], np.int64)
        arrays["__ret_tcp__"] = (np.stack([self.retired_kfs[u][0] for u in ruids]) if ruids
                                 else np.zeros((0, 4, 4), np.float32))
        arrays["__loop_edges__"] = np.asarray(self.loop_edges, np.int64).reshape(-1, 2)
        meta = {k: getattr(self, k) for k in self._SCALARS}
        meta["desc_dtype"] = np.dtype(self.desc_dtype).name
        np.savez_compressed(path, __meta__=np.asarray([repr(meta)]), **arrays)

    @staticmethod
    def load(path: str, device="cuda") -> "SlamMap":
        """A map from a checkpoint of either package (read with
        allow_pickle=False); its point mirror will live on `device`."""
        z = np.load(path, allow_pickle=False)
        meta = ast.literal_eval(str(z["__meta__"][0]))
        m = SlamMap(max_kf=meta["max_kf"], max_pt=meta["max_pt"], n_feat=meta["n_feat"],
                    desc_dim=meta["desc_dim"], desc_dtype=np.dtype(meta["desc_dtype"]),
                    device=device)
        for k in z.files:
            if k == "__meta__" or k.startswith("__ret_") or k == "__loop_edges__":
                continue
            setattr(m, k, z[k])
        if "__loop_edges__" in z.files:
            m.loop_edges = [(int(a), int(b)) for a, b in z["__loop_edges__"]]
        m._next_kf = meta["_next_kf"]
        m._next_pt = meta["_next_pt"]
        m._uid_counter = meta.get("_uid_counter", int(m.kf_uid.max()) + 1)
        m.retired_kfs = {int(u): (t.astype(np.float32), int(p)) for u, p, t in
                         zip(z["__ret_uid__"], z["__ret_parent__"], z["__ret_tcp__"])}
        m.uid_slot = {int(m.kf_uid[s]): int(s) for s in np.nonzero(m.kf_valid)[0]
                      if m.kf_uid[s] >= 0}
        return m

    # ------------------------------------------------------------------ KFs
    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def keyframe_ids(self):
        return np.nonzero(self.kf_valid)[0]

    def inform_big_change(self):
        self.change_idx += 1

    def _grow_keyframes(self):
        """Double keyframe capacity in place (pads every kf_* array)."""
        old = self.max_kf
        self.max_kf = old * 2
        grow = old
        self.kf_valid = np.pad(self.kf_valid, (0, grow))
        self.kf_uid = np.pad(self.kf_uid, (0, grow), constant_values=-1)
        self.kf_parent = np.pad(self.kf_parent, (0, grow), constant_values=-1)
        self.kf_pose = np.concatenate(
            [self.kf_pose, np.tile(np.eye(4, dtype=np.float32), (grow, 1, 1))]
        )
        self.kf_ts = np.pad(self.kf_ts, (0, grow))
        self.kf_frame_id = np.pad(self.kf_frame_id, (0, grow), constant_values=-1)
        self.kf_matches = np.pad(self.kf_matches, ((0, grow), (0, 0)), constant_values=-1)
        for name in ("kf_uv", "kf_desc_bits", "kf_octave", "kf_angle"):
            arr = getattr(self, name)
            setattr(self, name, np.pad(arr, ((0, grow),) + ((0, 0),) * (arr.ndim - 1)))
        self.kf_size = np.pad(self.kf_size, ((0, grow), (0, 0)), constant_values=1.0)
        self.kf_inv_sigma2 = np.pad(self.kf_inv_sigma2, ((0, grow), (0, 0)),
                                    constant_values=1.0)
        self.kf_feat_valid = np.pad(self.kf_feat_valid, ((0, grow), (0, 0)))
        self.kf_depth = np.pad(self.kf_depth, ((0, grow), (0, 0)), constant_values=-1.0)

    def _grow_points(self, need: int):
        """Double point capacity (repeatedly) until `need` free slots
        exist. Point ids are preserved."""
        while (~self.pt_valid).sum() < need:
            old = self.max_pt
            self.max_pt = old * 2
            grow = old
            self.pt_valid = np.pad(self.pt_valid, (0, grow))
            self.pt_pos = np.pad(self.pt_pos, ((0, grow), (0, 0)))
            self.pt_desc_bits = np.pad(self.pt_desc_bits, ((0, grow), (0, 0)))
            self.pt_normal = np.pad(self.pt_normal, ((0, grow), (0, 0)))
            for name in ("pt_min_dist", "pt_max_dist", "pt_visible", "pt_found"):
                setattr(self, name, np.pad(getattr(self, name), (0, grow)))
            for name, fill in (("pt_ref_kf", -1), ("pt_first_kf", -1),
                               ("pt_replaced", -1), ("pt_freed_rev", -(10 ** 9))):
                setattr(self, name, np.pad(getattr(self, name), (0, grow),
                                           constant_values=fill))
            self.pt_ref_size = np.pad(self.pt_ref_size, (0, grow), constant_values=1.0)
            self.pt_ref_dist = np.pad(self.pt_ref_dist, (0, grow), constant_values=1.0)
            self.pt_dirty = np.pad(self.pt_dirty, (0, grow))
            self._mirror = None  # capacity changed: full re-upload

    def add_keyframe(self, pose, ts, frame_id, feats, matches) -> int:
        """feats: dict of numpy arrays from the frontend (+ uv_und)."""
        self.rev += 1
        free = np.nonzero(~self.kf_valid)[0]
        if len(free) == 0:
            self._grow_keyframes()
            free = np.nonzero(~self.kf_valid)[0]
        kf = int(free[0])
        self.kf_parent[kf] = -1
        self.kf_pose[kf] = pose
        self.kf_ts[kf] = ts
        self.kf_frame_id[kf] = frame_id
        self.kf_uv[kf] = feats["uv_und"]
        self.kf_desc_bits[kf] = feats["desc_bits"]
        self.kf_octave[kf] = feats["octave"]
        self.kf_size[kf] = feats["size"]
        self.kf_angle[kf] = feats["angle"]
        self.kf_inv_sigma2[kf] = feats["inv_sigma2"]
        self.kf_feat_valid[kf] = feats["valid"]
        self.kf_depth[kf] = feats.get("depth", -1.0)
        self.kf_matches[kf] = matches
        self._next_kf = max(self._next_kf, kf + 1)
        uid = self._uid_counter
        self._uid_counter += 1
        self.kf_uid[kf] = uid
        self.uid_slot[uid] = kf
        self.kf_valid[kf] = True
        return kf

    def remove_keyframe(self, kf: int):
        """Cull a keyframe; retire its identity against a surviving anchor
        and re-parent its spanning-tree children (reference SetBadFlag,
        src/KeyFrame.cc:492-588)."""
        self.rev += 1
        old_parent = int(self.kf_parent[kf])
        if not (old_parent >= 0 and self.kf_valid[old_parent]):
            old_parent = -1
        children = {
            int(c)
            for c in np.nonzero((self.kf_parent == kf) & self.kf_valid)[0]
            if int(c) != kf
        }
        if children:
            candidates = [old_parent] if old_parent >= 0 else []
            w_cache = {c: self.covisibility_weights(c) for c in children}
            while children and candidates:
                best = None
                for c in children:
                    w = w_cache[c]
                    for cand in candidates:
                        wt = int(w[cand])
                        if wt > 0 and (best is None or wt > best[2]):
                            best = (c, cand, wt)
                if best is None:
                    break
                c, cand, _ = best
                self.kf_parent[c] = cand
                candidates.append(c)
                children.remove(c)
            for c in children:  # no covisible candidate: attach to grandparent
                self.kf_parent[c] = old_parent

        uid = int(self.kf_uid[kf])
        if uid >= 0:
            parent = old_parent
            if parent < 0:
                cov, _ = self.covisible_keyframes(kf, min_weight=1, max_n=1)
                parent = int(cov[0]) if len(cov) else -1
            if parent >= 0 and parent != kf and self.kf_valid[parent]:
                t_cp = self.kf_pose[kf] @ np.linalg.inv(self.kf_pose[parent])
                self.retired_kfs[uid] = (t_cp.astype(np.float32), int(self.kf_uid[parent]))
            self.uid_slot.pop(uid, None)
            self.kf_uid[kf] = -1
        self.kf_valid[kf] = False
        self.kf_parent[kf] = -1
        self.kf_matches[kf] = -1
        if self.on_kf_removed is not None:
            self.on_kf_removed(kf)

    def resolve_anchor(self, t_cr: np.ndarray, uid: int):
        """Walk retired-keyframe parents until a live anchor; returns the
        world pose T_cw = accumulated_T_cr @ T_parent_w, or None."""
        t_cr = np.asarray(t_cr, np.float32)
        while uid in self.retired_kfs:
            t_cp, uid = self.retired_kfs[uid]
            t_cr = t_cr @ t_cp
        slot = self.uid_slot.get(int(uid))
        if slot is None or not self.kf_valid[slot]:
            return None
        return t_cr @ self.kf_pose[slot]

    # --------------------------------------------------------------- points
    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    # quarantine window in revisions before a freed slot may be reused
    FREED_QUARANTINE_REVS = 64

    def add_points(self, positions, desc_bits, ref_kf, ref_sizes, first_kf=None):
        """Bulk-add points; returns assigned ids (int32 array)."""
        self.rev += 1
        m = len(positions)

        def eligible():
            return ~self.pt_valid & (self.rev - self.pt_freed_rev > self.FREED_QUARANTINE_REVS)

        free = np.nonzero(eligible())[0][:m]
        if len(free) < m:
            self._grow_points(m + int((~eligible()).sum()))
            free = np.nonzero(eligible())[0][:m]
        ids = free.astype(np.int32)
        self.pt_valid[ids] = True
        self.pt_replaced[ids] = -1
        # stale forwarding links into recycled slots must not resurrect
        self.pt_replaced[np.isin(self.pt_replaced, ids)] = -1
        self.pt_pos[ids] = positions
        self.pt_desc_bits[ids] = desc_bits
        self.pt_ref_kf[ids] = ref_kf
        self.pt_ref_size[ids] = ref_sizes
        self.pt_first_kf[ids] = ref_kf if first_kf is None else first_kf
        self.pt_visible[ids] = 1
        self.pt_found[ids] = 1
        self.pt_dirty[ids] = True
        return ids

    def remove_points(self, ids):
        self.rev += 1
        ids = np.asarray(ids, np.int32)
        if len(ids) == 0:
            return
        self.pt_valid[ids] = False
        self.pt_freed_rev[ids] = self.rev
        self.pt_dirty[ids] = True
        drop = np.zeros(self.max_pt, bool)
        drop[ids] = True
        mm = self.kf_matches
        mm[(mm >= 0) & drop[np.maximum(mm, 0)]] = -1

    def merge_points(self, keep_ids, drop_ids):
        """Replace each drop point with its keep point everywhere (reference
        MapPoint::Replace, src/MapPoint.cc:213-252). Deduplicates slots."""
        self.rev += 1
        remap = {}
        for keep, drop in zip(keep_ids, drop_ids):
            keep, drop = int(keep), int(drop)
            if keep == drop or not self.pt_valid[keep] or not self.pt_valid[drop]:
                continue
            remap[drop] = keep
        if not remap:
            return
        drop_arr = np.asarray(list(remap.keys()))
        keep_arr = np.asarray(list(remap.values()))
        lut = np.arange(self.max_pt, dtype=np.int32)
        lut[drop_arr] = keep_arr
        mm = self.kf_matches
        sel = mm >= 0
        mm[sel] = lut[mm[sel]]
        # per-row dedup, first occurrence kept
        order = np.argsort(mm, axis=1, kind="stable")
        sorted_m = np.take_along_axis(mm, order, axis=1)
        dup = (sorted_m[:, 1:] == sorted_m[:, :-1]) & (sorted_m[:, 1:] >= 0)
        ri, ci = np.nonzero(dup)
        if len(ri):
            mm[ri, order[ri, ci + 1]] = -1
        self.pt_found[keep_arr] += self.pt_found[drop_arr]
        self.pt_visible[keep_arr] += self.pt_visible[drop_arr]
        self.pt_valid[drop_arr] = False
        self.pt_freed_rev[drop_arr] = self.rev
        self.pt_replaced[drop_arr] = keep_arr
        self.pt_dirty[drop_arr] = True

    # ----------------------------------------------------------- structure
    def observations_of_points(self, pt_ids):
        """COO (kf, slot, pt) observation triples for the given points."""
        pt_ids = np.asarray(pt_ids)
        if len(pt_ids) == 0:
            return (np.zeros(0, np.int32),) * 3
        want = np.zeros(self.max_pt, bool)
        want[pt_ids] = True
        kfs = self.keyframe_ids()
        m = self.kf_matches[kfs]
        sel = (m >= 0) & want[np.maximum(m, 0)]
        ki, slots = np.nonzero(sel)
        return kfs[ki].astype(np.int32), slots.astype(np.int32), m[ki, slots].astype(np.int32)

    def point_observation_counts(self, stereo_weighted: bool = False):
        """(max_pt,) observation tally per point, cached on the map
        revision. stereo_weighted: a depth-bearing observation counts 2
        (reference MapPoint::GetNumberOfObservations)."""
        cache = self._obs_counts_cache
        key = (self.rev, stereo_weighted)
        if cache is not None and cache[0] == key:
            return cache[1]
        if stereo_weighted:
            kfs = self.keyframe_ids()
            m = self.kf_matches[kfs]
            sel = m >= 0
            w = 1 + (self.kf_depth[kfs][sel] > 0).astype(np.int64)
            counts = np.bincount(m[sel], weights=w, minlength=self.max_pt).astype(np.int64)
        else:
            counts = native.point_obs_counts(self.kf_matches, self.kf_valid, self.max_pt)
        self._obs_counts_cache = (key, counts)
        return counts

    def covisibility_weights(self, kf: int):
        """(max_kf,) number of map points shared with `kf`."""
        return native.covisibility_weights(self.kf_matches, self.kf_valid, int(kf), self.max_pt)

    def covisible_keyframes(self, kf: int, min_weight: int = 15, max_n: int | None = None):
        w = self.covisibility_weights(kf)
        ids = np.nonzero(w >= min_weight)[0]
        order = np.argsort(-w[ids], kind="stable")
        ids = ids[order]
        if max_n is not None:
            ids = ids[:max_n]
        return ids, w

    def kf_centers(self):
        """(max_kf, 3) float32 camera centres of the valid keyframes, 0
        elsewhere."""
        centers = np.zeros((self.max_kf, 3), np.float32)
        live = self.keyframe_ids()
        if len(live):
            r = self.kf_pose[live, :3, :3]
            t = self.kf_pose[live, :3, 3]
            centers[live] = -np.einsum("kij,ki->kj", r, t)
        return centers

    def update_point_stats(self, pt_ids=None):
        """Recompute distinctive descriptor, mean normal and scale band for
        points (reference MapPoint::ComputeDistinctiveDescriptors :279-349,
        UpdateNormalAndDepth :372-430)."""
        self.rev += 1
        if pt_ids is None:
            pt_ids = np.nonzero(self.pt_valid)[0]
        pt_ids = np.unique(np.asarray(pt_ids, np.int64))
        if len(pt_ids) == 0:
            return
        native.update_point_stats(
            self.kf_matches, self.kf_valid, self.kf_desc_bits, self.kf_size, self.kf_centers(),
            pt_ids, self.pt_pos, self.pt_ref_kf, self.pt_desc_bits, self.pt_normal,
            self.pt_ref_size, self.pt_ref_dist, self.pt_min_dist, self.pt_max_dist)
        # mark after the write: a mirror sync that cleared the flag before
        # it would leave these rows stale
        self.pt_dirty[pt_ids] = True
