"""Bag-of-words vocabulary: a hierarchical k-means tree and its batched
descent (port of anyfeature_vslam_tpu/place_recognition/vocab.py).

The counterpart of DBoW2's TemplatedVocabulary (reference
include/Vocabulary.h:22-30, src/Vocabulary.cpp:54-206). The vocabulary is
a balanced tree stored level by level (``centroids[l]`` holds
branching^(l+1) rows); ``transform_words`` walks every descriptor down the
tree at once, each level one masked distance and first-minimum over the
node's children, in plain PyTorch on the caller's device (the JAX package
runs it outside any Pallas kernel too). The shipped orb32 tree
(``vocabularies/voc_orb32_38k.npz``: branching 14, depth 4, 38,416 words)
is uploaded once per device and kept there (``Vocabulary.centroids_on``).

Training (``train_vocabulary``, ``_kmeans``, ``_dist``) is host numpy,
copied from the JAX package so that the same seed gives the same tree.
DBoW2 text vocabularies (``.txt``, the JAX package's dbow2_io.py) are not
ported: ROADMAP.md queue item 14.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Vocabulary:
    branching: int
    depth: int
    centroids: list  # [level] -> (branching^(l+1), D) uint8 {0,1} or float
    idf: np.ndarray  # (n_words,) float32
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth

    def centroids_on(self, device) -> list:
        """The tree's levels as tensors on `device`, uploaded on first use."""
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = [torch.from_numpy(np.ascontiguousarray(c)).to(device)
                              for c in self.centroids]
        return self._dev[key]

    def save(self, path: str):
        np.savez_compressed(
            path, branching=self.branching, depth=self.depth, idf=self.idf,
            **{f"level_{l}": c for l, c in enumerate(self.centroids)})

    @staticmethod
    def load(path: str):
        if path.endswith(".txt"):
            raise NotImplementedError(
                "DBoW2 text vocabularies are not ported to the torch package yet: ROADMAP.md "
                "queue item 14")
        z = np.load(path)
        depth = int(z["depth"])
        return Vocabulary(branching=int(z["branching"]), depth=depth,
                          centroids=[z[f"level_{l}"] for l in range(depth)],
                          idf=z["idf"].astype(np.float32))


def _dist(a, b, chunk: int = 16384):
    """Pairwise distances, Hamming for uint8 bit-planes, sq-L2 for float.
    Chunked over `a` so large training corpora don't materialize an
    (N, K, D) intermediate."""
    if len(a) <= chunk:
        if a.dtype == np.uint8:
            return (a[:, None, :] != b[None, :, :]).sum(-1)
        diff = a[:, None, :].astype(np.float32) - b[None, :, :].astype(np.float32)
        return (diff * diff).sum(-1)
    out = np.empty((len(a), len(b)), np.int64 if a.dtype == np.uint8 else np.float32)
    for i in range(0, len(a), chunk):
        out[i:i + chunk] = _dist(a[i:i + chunk], b)
    return out


def _kmeans(descs: np.ndarray, k: int, iters: int, rng) -> np.ndarray:
    """K-means with descriptor-family-appropriate centroids: majority-vote
    for binary (DBoW2's binary clustering), mean for float."""
    binary = descs.dtype == np.uint8
    n = len(descs)
    if n <= k:
        cents = np.zeros((k, descs.shape[1]), descs.dtype)
        cents[:n] = descs
        return cents
    cents = descs[rng.choice(n, k, replace=False)].copy()
    for _ in range(iters):
        assign = _dist(descs, cents).argmin(1)
        for j in range(k):
            members = descs[assign == j]
            if len(members) == 0:
                cents[j] = descs[rng.integers(n)]
            elif binary:
                cents[j] = (members.mean(0) > 0.5).astype(np.uint8)
            else:
                cents[j] = members.mean(0).astype(descs.dtype)
    return cents


def train_vocabulary(desc_bits: np.ndarray, branching: int = 32, depth: int = 2,
                     iters: int = 8, seed: int = 0, max_train: int = 50000) -> Vocabulary:
    """Hierarchical k-means (host numpy; offline tool path). Accepts uint8
    bit-plane descriptors (Hamming) or float descriptors (L2)."""
    rng = np.random.default_rng(seed)
    descs = np.asarray(desc_bits)
    if len(descs) > max_train:
        descs = descs[rng.choice(len(descs), max_train, replace=False)]

    centroids = [_kmeans(descs, branching, iters, rng)]
    for level in range(1, depth):
        # assign all descriptors down the tree built so far to find their node
        node_ids = np.zeros(len(descs), np.int64)
        for l in range(level):
            c = centroids[l]
            k = branching
            child = np.zeros(len(descs), np.int64)
            for gi in np.unique(node_ids):
                sel = node_ids == gi
                cands = c[gi * k:(gi + 1) * k]
                child[sel] = gi * k + _dist(descs[sel], cands).argmin(1)
            node_ids = child
        k = branching
        c_lvl = np.zeros((branching ** (level + 1), descs.shape[1]), descs.dtype)
        for gi in range(branching ** level):
            members = descs[node_ids == gi]
            c_lvl[gi * k:(gi + 1) * k] = _kmeans(members, k, iters, rng)
        centroids.append(c_lvl)

    vocab = Vocabulary(branching, depth, centroids, np.ones(branching ** depth, np.float32))
    # idf from the training corpus ("documents" = chunks of ~500
    # descriptors); the descent runs on the CPU in bounded chunks
    words = np.concatenate([
        transform_words(vocab, torch.from_numpy(descs[i:i + 16384]),
                        torch.ones(len(descs[i:i + 16384]), dtype=torch.bool)).numpy()
        for i in range(0, len(descs), 16384)])
    n_docs = max(len(descs) // 500, 1)
    df = np.zeros(vocab.n_words, np.float64)
    for c in range(n_docs):
        df[np.unique(words[c * 500:(c + 1) * 500])] += 1
    vocab.idf = np.log(n_docs / np.clip(df, 1.0, None)).astype(np.float32) + 1e-3
    return vocab


def transform_words(vocab: Vocabulary, desc_bits, valid):
    """(N, D) descriptors and (N,) validity (tensors on one device) -> (N,)
    int32 word ids, -1 for invalid rows. Each level picks the child with
    the smallest distance, the first one among equals (``jnp.argmin``'s
    rule, made explicit: the key distance * branching + child is unique)."""
    cents = vocab.centroids_on(desc_bits.device)
    b = vocab.branching
    n = desc_bits.shape[0]
    binary = desc_bits.dtype == torch.uint8
    d = desc_bits.to(torch.int16) if binary else desc_bits.to(torch.float32)
    node = torch.zeros(n, dtype=torch.int64, device=desc_bits.device)
    child = torch.arange(b, device=desc_bits.device)
    for level in range(vocab.depth):
        base = node * b
        cand = cents[level][base[:, None] + child[None, :]]  # (N, B, D)
        if binary:
            dist = (d[:, None, :] - cand.to(torch.int16)).abs().sum(-1, dtype=torch.int64)
            pick = torch.amin(dist * b + child[None, :], dim=-1) % b
        else:
            diff = d[:, None, :] - cand.to(torch.float32)
            pick = torch.argmin((diff * diff).sum(-1), dim=-1)
        node = base + pick
    return torch.where(valid, node, torch.full_like(node, -1)).to(torch.int32)


def bow_from_words(words, idf):
    """(N,) word ids (-1 skipped) and the (n_words,) idf tensor -> the
    L1-normalized tf-idf histogram (n_words,) float32."""
    n_words = idf.shape[0]
    w = torch.clamp(words.to(torch.int64), 0, n_words - 1)
    counts = torch.zeros(n_words, dtype=torch.float32, device=idf.device).index_add_(
        0, w, (words >= 0).to(torch.float32))
    v = counts * idf
    norm = torch.sum(torch.abs(v))
    return v / torch.where(norm > 0, norm, torch.ones_like(norm))


def bow_vector(vocab: Vocabulary, desc_bits, valid):
    """L1-normalized tf-idf histogram (n_words,) float32."""
    words = transform_words(vocab, desc_bits, valid)
    return bow_from_words(words, torch.from_numpy(vocab.idf).to(desc_bits.device))


def l1_score(bow_a, bow_b):
    """DBoW2 L1 score 1 - 0.5 |va - vb|_1 of L1-normalized vectors
    (reference src/Vocabulary.cpp:132-154); bow_b may be batched (K, W)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(bow_a[None, :] - bow_b), dim=-1)
