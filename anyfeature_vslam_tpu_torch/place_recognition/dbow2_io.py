"""DBoW2 text vocabularies: load, save and the batched tree descent (port of
anyfeature_vslam_tpu/place_recognition/dbow2_io.py).

The reference loads per-feature DBoW2 vocabularies from text files
(``ORBvoc.txt``, ``<Feature>_DBoW2_voc.txt``; reference
src/Vocabulary.cpp:54-106, DBoW2 TemplatedVocabulary text format):

    line 1:  <k> <L> <scoring> <weighting>
    line i:  <parent_id> <is_leaf 0|1> <descriptor values...> <weight>

Node ids are implicit (root = 0, file lines create nodes 1..N in order);
leaves get word ids in reading order. Binary descriptors are byte rows
(32 bytes for ORB), expanded to the framework's {0,1} bit planes, LSB
first; float descriptors are kept as float32.

``transform_words_dbow2`` walks every descriptor down the tree at once:
per level the node's children are gathered, their distances taken
(Hamming as a sum of |bit differences| in int16, which cannot wrap; squared
L2 in float32) and the first child with the smallest distance is picked;
a descriptor at a leaf stays there. Plain PyTorch on the caller's device,
as the JAX package runs it outside any Pallas kernel. The node arrays are
uploaded once per device (``Dbow2Vocabulary.nodes_on``). Word ids are the
DBoW2 ones, bucketed by ``% fold`` when ``fold`` is below the word count.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Dbow2Vocabulary:
    branching: int
    depth: int
    children: np.ndarray     # (n_nodes, k) int32 child node ids, -1 pad
    node_desc: np.ndarray    # (n_nodes, D) uint8 bit planes or float32
    leaf_word: np.ndarray    # (n_nodes,) int32 word id or -1
    word_weight: np.ndarray  # (n_raw_words,) float32 (file weights)
    fold: int                # dense-histogram bucket count
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_words(self) -> int:
        return self.fold

    @property
    def idf(self) -> np.ndarray:
        """Per-word weight; folded (max over bucket) only when fold < the
        raw word count."""
        cached = self.__dict__.get("_idf_folded")
        if cached is None:
            if self.fold >= len(self.word_weight):
                cached = np.where(self.word_weight > 0, self.word_weight,
                                  1e-3).astype(np.float32)
            else:
                w = np.zeros(self.fold, np.float32)
                np.maximum.at(w, np.arange(len(self.word_weight)) % self.fold,
                              self.word_weight.astype(np.float32))
                cached = np.where(w > 0, w, 1e-3)
            self.__dict__["_idf_folded"] = cached
        return cached

    def nodes_on(self, device) -> tuple:
        """(children int64, node descriptors, leaf words int64) as tensors
        on `device`, uploaded on first use."""
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = (
                torch.from_numpy(self.children.astype(np.int64)).to(device),
                torch.from_numpy(np.ascontiguousarray(self.node_desc)).to(device),
                torch.from_numpy(self.leaf_word.astype(np.int64)).to(device))
        return self._dev[key]


def _bytes_to_bitplanes(rows: np.ndarray) -> np.ndarray:
    """(N, B) bytes -> (N, 8B) uint8 {0,1}, LSB first per byte (cv::Mat
    byte order)."""
    return np.unpackbits(rows.astype(np.uint8), axis=1, bitorder="little")


def load_dbow2_text(path: str, binary: bool | None = None,
                    fold: int | None = None) -> Dbow2Vocabulary:
    """Parse a DBoW2 text vocabulary. binary None: byte rows (integer
    values in 0..255, 16, 32, 48, 61 or 64 of them) are binary."""
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        rows = [parts for parts in (line.split() for line in f) if len(parts) >= 3]
    table = np.asarray(rows, np.float64).reshape(len(rows), -1)
    parents = table[:, 0].astype(np.int64)
    leaf_flags = table[:, 1].astype(np.int64)
    d_raw = table[:, 2:-1]
    weights = table[:, -1]
    if binary is None:
        binary = bool(np.all(d_raw == np.round(d_raw)) and d_raw.min() >= 0
                      and d_raw.max() <= 255 and d_raw.shape[1] in (16, 32, 48, 61, 64))
    node_desc_rows = _bytes_to_bitplanes(d_raw) if binary else d_raw.astype(np.float32)

    n_lines = len(parents)
    n_nodes = n_lines + 1  # + root
    node_desc = np.zeros((n_nodes, node_desc_rows.shape[1]), node_desc_rows.dtype)
    node_desc[1:] = node_desc_rows
    children = np.full((n_nodes, k), -1, np.int32)
    # a node's children in file order, at most k of them
    order = np.argsort(parents, kind="stable")
    sorted_par = parents[order]
    first = np.searchsorted(sorted_par, sorted_par, side="left")
    rank = np.arange(n_lines) - first
    keep = rank < k
    children[sorted_par[keep], rank[keep]] = order[keep] + 1
    leaf_word = np.full(n_nodes, -1, np.int32)
    leaves = np.nonzero(leaf_flags)[0]
    leaf_word[leaves + 1] = np.arange(len(leaves), dtype=np.int32)
    word_weight = weights[leaves].astype(np.float32)
    n_words = len(leaves)
    return Dbow2Vocabulary(
        branching=k, depth=depth, children=children, node_desc=node_desc,
        leaf_word=leaf_word, word_weight=word_weight,
        fold=max(n_words, 1) if fold is None else min(fold, max(n_words, 1)))


def transform_words_dbow2(vocab: Dbow2Vocabulary, desc_bits, valid):
    """(N, D) descriptors (uint8 bit planes or float) and (N,) validity,
    tensors on one device -> (N,) int32 folded word ids, -1 for invalid
    rows."""
    children, node_desc, leaf_word = vocab.nodes_on(desc_bits.device)
    k = vocab.branching
    n = desc_bits.shape[0]
    binary = desc_bits.dtype == torch.uint8
    d = desc_bits.to(torch.int16) if binary else desc_bits.to(torch.float32)
    node = torch.zeros(n, dtype=torch.int64, device=desc_bits.device)
    child = torch.arange(k, device=desc_bits.device)
    for _ in range(vocab.depth + 1):  # + 1: unbalanced trees may run deep
        ch = children[node]  # (N, k)
        has_child = ch >= 0
        cands = node_desc[ch.clamp(min=0)]  # (N, k, D)
        if binary:
            dist = (d[:, None, :] - cands.to(torch.int16)).abs().sum(-1, dtype=torch.int64)
            # the first child among equals: distance * k + child is unique
            key = torch.where(has_child, dist * k + child[None, :],
                              torch.full_like(dist, torch.iinfo(torch.int64).max))
            best = torch.amin(key, dim=-1) % k
        else:
            diff = d[:, None, :] - cands.to(torch.float32)
            dist = torch.where(has_child, (diff * diff).sum(-1),
                               torch.full(has_child.shape, torch.inf, device=d.device))
            best = torch.argmin(dist, dim=-1)
        nxt = torch.gather(ch, 1, best[:, None])[:, 0].to(torch.int64)
        node = torch.where(has_child.any(-1), nxt, node)  # stay at a leaf
    word = leaf_word[node]
    ok = valid & (word >= 0)
    return torch.where(ok, word % vocab.fold, torch.full_like(word, -1)).to(torch.int32)


def save_dbow2_text(vocab, path: str):
    """Write a balanced ``vocab.Vocabulary`` in the DBoW2 text format,
    breadth first (level l's nodes are centroids[l]'s rows, their parents
    the previous level's nodes, the root 0), leaves weighted by the idf."""
    k, depth = vocab.branching, vocab.depth
    lines = [f"{k} {depth} 0 0"]
    binary = vocab.centroids[0].dtype == np.uint8
    node_id_of = {}
    next_id = 1
    for level in range(depth):
        cents = vocab.centroids[level]
        for row in range(len(cents)):
            parent = 0 if level == 0 else node_id_of[(level - 1, row // k)]
            is_leaf = 1 if level == depth - 1 else 0
            weight = float(vocab.idf[row]) if is_leaf else 0.0
            if binary:
                bits = np.packbits(cents[row].astype(np.uint8), bitorder="little")
                desc_str = " ".join(str(int(b)) for b in bits)
            else:
                desc_str = " ".join(f"{float(v):.6f}" for v in cents[row])
            lines.append(f"{parent} {is_leaf} {desc_str} {weight}")
            node_id_of[(level, row)] = next_id
            next_id += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
