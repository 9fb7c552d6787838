"""Keyframe database: loop and relocalization candidate retrieval (port of
anyfeature_vslam_tpu/place_recognition/database.py).

The counterpart of the reference KeyFrameDatabase (reference
src/KeyFrameDatabase.cc:33-309). The DBoW2 inverted file becomes sparse
per-keyframe word lists: each keyframe stores its (word id, tf-idf weight)
pairs in fixed-width host arrays, and the L1 score of two L1-normalized
vectors, 1 - 0.5 |a - b|_1, is the sum over common words of min(a_w, b_w).
The database is host numpy, as in the JAX package; only the query's
vocabulary descent runs on the device (``compute_bow``, one fetch of the
word ids). Selection semantics:

  loop candidates (KeyFrameDatabase.cc:76-197): exclude the query's
    covisible keyframes; shared-word count > 0.8 * max shared; L1 score >=
    minScore; scores accumulated over each candidate's 10 best covisibles,
    groups above 0.75 * the best accumulated score (best member returned);
  relocalization candidates (KeyFrameDatabase.cc:199-309): the same without
    the covisibility exclusion and minScore gate, ordered by score.

The threaded mode's deferred transform (``dispatch_bow``) is ROADMAP.md
queue item 8.
"""

from __future__ import annotations

import numpy as np
import torch

from . import vocab as vocab_mod


def covisibility_matrix(kf_matches, kf_valid, max_pt: int):
    """(K, K) int32 shared-observation counts between valid keyframes: for
    each point, every pair of its observations adds one to both keyframes'
    entries (the JAX package's native covisibility_matrix; the diagonal
    counts a keyframe's own repeated observations)."""
    k = kf_matches.shape[0]
    out = np.zeros((k, k), np.int32)
    kfs = np.nonzero(kf_valid)[0]
    if len(kfs) == 0:
        return out
    m = kf_matches[kfs]
    ri, ci = np.nonzero((m >= 0) & (m < max_pt))
    if len(ri) == 0:
        return out
    pts, col = np.unique(m[ri, ci], return_inverse=True)
    counts = np.zeros((len(kfs), len(pts)), np.float64)
    np.add.at(counts, (ri, col), 1.0)
    w = counts @ counts.T
    w[np.diag_indices(len(kfs))] -= counts.sum(1)
    out[np.ix_(kfs, kfs)] = np.rint(w).astype(np.int32)
    return out


class KeyFrameDatabase:
    def __init__(self, vocabulary: vocab_mod.Vocabulary, max_kf: int, device="cuda"):
        self.vocab = vocabulary
        self.max_kf = max_kf
        self.device = torch.device(device)
        # sparse per-KF word lists: ids (-1 pad) + L1-normalized tf-idf
        # weights, width grown on demand
        self._cap = 64
        self.kf_words = np.full((max_kf, self._cap), -1, np.int32)
        self.kf_weights = np.zeros((max_kf, self._cap), np.float32)
        self.present = np.zeros(max_kf, bool)
        self._groups_cache = None

    def bow_from_words(self, words):
        """Sparse bow (unique word ids, L1-normalized tf-idf weights) from a
        fetched word-id array."""
        words = np.asarray(words)
        ids, counts = np.unique(words[words >= 0], return_counts=True)
        w = counts.astype(np.float32) * self.vocab.idf[ids]
        norm = np.abs(w).sum()
        if norm > 0:
            w = w / norm
        return ids.astype(np.int32), w

    def compute_bow(self, desc_bits, valid):
        """Sparse bow of a descriptor set (numpy arrays or tensors): the tree
        descent on the database's device, then one fetch of the word ids."""
        if not isinstance(desc_bits, torch.Tensor):
            desc_bits = torch.from_numpy(np.ascontiguousarray(desc_bits))
            valid = torch.from_numpy(np.ascontiguousarray(valid))
        words = vocab_mod.transform_words(self.vocab, desc_bits.to(self.device),
                                          valid.to(self.device))
        return self.bow_from_words(words.cpu().numpy())

    def add(self, kf: int, desc_bits=None, valid=None, bow=None):
        while kf >= self.max_kf:
            # track SlamMap keyframe-capacity growth
            self.kf_words = np.pad(self.kf_words, ((0, self.max_kf), (0, 0)), constant_values=-1)
            self.kf_weights = np.pad(self.kf_weights, ((0, self.max_kf), (0, 0)))
            self.present = np.pad(self.present, (0, self.max_kf))
            self.max_kf *= 2
        ids, w = bow if bow is not None else self.compute_bow(desc_bits, valid)
        while len(ids) > self._cap:
            self.kf_words = np.pad(self.kf_words, ((0, 0), (0, self._cap)), constant_values=-1)
            self.kf_weights = np.pad(self.kf_weights, ((0, 0), (0, self._cap)))
            self._cap *= 2
        self.kf_words[kf] = -1
        self.kf_weights[kf] = 0.0
        self.kf_words[kf, :len(ids)] = ids
        self.kf_weights[kf, :len(ids)] = w
        self.present[kf] = True

    def erase(self, kf: int):
        self.present[kf] = False

    def _shared_and_scores(self, bow_q, exclude):
        """Shared-word counts and L1 scores of the sparse query (ids,
        weights) against every keyframe, in one gather over the tables."""
        ids_q, w_q = bow_q
        cand = self.present & ~exclude
        q_w = np.zeros(self.vocab.n_words, np.float32)
        q_w[ids_q] = w_q
        q_has = np.zeros(self.vocab.n_words, bool)
        q_has[ids_q] = True
        valid_slot = self.kf_words >= 0
        wi = np.maximum(self.kf_words, 0)
        common = valid_slot & q_has[wi]
        shared = np.where(cand, common.sum(-1), 0)
        scores = np.where(common, np.minimum(q_w[wi], self.kf_weights), 0.0).sum(-1)
        return cand, shared, scores.astype(np.float32)

    def _query(self, bow_q, exclude, min_score, covis_groups, order_by_score: bool = False):
        cand, shared, scores = self._shared_and_scores(bow_q, exclude)
        if shared.max(initial=0) == 0:
            return []
        min_common = 0.8 * shared.max()
        ok = cand & (shared > min_common) & (scores >= min_score)
        if not ok.any():
            return []
        # accumulate over covisibility groups
        acc_best = []
        for kf in np.nonzero(ok)[0]:
            group = [kf] + [g for g in covis_groups.get(int(kf), [])
                            if ok[g] or (cand[g] and shared[g] > min_common)]
            acc = float(scores[group].sum())
            best_kf = int(group[int(np.argmax(scores[group]))])
            acc_best.append((acc, best_kf))
        th = 0.75 * max(a for a, _ in acc_best)
        out, seen = [], set()
        # relocalization keeps a fixed number of candidates, so it takes them
        # in score order; loop detection tries every candidate in slot order
        ranked = sorted(acc_best, key=lambda x: -x[0]) if order_by_score else acc_best
        for acc, kf in ranked:
            if acc > th and kf not in seen:
                seen.add(kf)
                out.append(kf)
        return out

    def detect_loop_candidates(self, kf: int, slam_map, min_score: float, bow_q=None):
        """Candidates for closing a loop at `kf` (its covisibles excluded).
        The query keyframe need not be in the database yet."""
        if bow_q is None:
            bow_q = self._kf_bow(kf, slam_map)
        cov, _ = slam_map.covisible_keyframes(kf, min_weight=15)
        exclude = np.zeros(self.max_kf, bool)
        if kf < self.max_kf:
            exclude[kf] = True
        cov = np.asarray(cov)
        exclude[cov[cov < self.max_kf]] = True
        return self._query(bow_q, exclude, min_score, self._covis_groups(slam_map))

    def _kf_bow(self, kf: int, slam_map):
        if kf < self.max_kf and self.present[kf]:
            v = self.kf_words[kf] >= 0
            return self.kf_words[kf][v], self.kf_weights[kf][v]
        return self.compute_bow(slam_map.kf_desc_bits[kf], slam_map.kf_feat_valid[kf])

    def detect_relocalization_candidates(self, desc_bits, valid, slam_map):
        """Candidates for a frame's descriptors (numpy or device tensors),
        best accumulated score first."""
        bow_q = self.compute_bow(desc_bits, valid)
        exclude = np.zeros(self.max_kf, bool)
        return self._query(bow_q, exclude, 0.0, self._covis_groups(slam_map),
                           order_by_score=True)

    def _covis_groups(self, slam_map, top: int = 10):
        """Top-covisible groups of every present keyframe from one
        covisibility-matrix pass, cached on the map revision."""
        rev = slam_map.rev
        if self._groups_cache is not None and self._groups_cache[0] == rev:
            return self._groups_cache[1]
        w = covisibility_matrix(slam_map.kf_matches, slam_map.kf_valid, slam_map.max_pt)
        groups = {}
        for kf in np.nonzero(self.present)[0]:
            kf = int(kf)
            if kf >= w.shape[0] or not slam_map.kf_valid[kf]:
                continue
            row = w[kf].copy()
            row[kf] = 0
            ids = np.nonzero(row >= 15)[0]
            ids = ids[np.argsort(-row[ids], kind="stable")][:top]
            groups[kf] = [int(c) for c in ids if c < self.max_kf]
        self._groups_cache = (rev, groups)
        return groups

    def min_score_vs_covisibles(self, kf: int, slam_map, bow_q=None) -> float:
        """Reference DetectLoop: minScore = the smallest BoW score between
        the new keyframe and its covisibles (LoopClosing.cc:136-151)."""
        cov, _ = slam_map.covisible_keyframes(kf, min_weight=15)
        cov = [int(c) for c in cov if c < self.max_kf and self.present[c]]
        if len(cov) == 0:
            return 0.0
        ids_q, w_q = bow_q if bow_q is not None else self._kf_bow(kf, slam_map)
        q_w = np.zeros(self.vocab.n_words, np.float32)
        q_w[ids_q] = w_q
        wi = np.maximum(self.kf_words[cov], 0)
        common = (self.kf_words[cov] >= 0) & (q_w[wi] > 0)
        scores = np.where(common, np.minimum(q_w[wi], self.kf_weights[cov]), 0.0).sum(-1)
        return float(scores.min())
