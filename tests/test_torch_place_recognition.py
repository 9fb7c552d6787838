"""Place recognition of the PyTorch port against the JAX package: the
vocabulary, its tree descent, bag-of-words vectors, training, and the
keyframe database's loop and relocalization candidates.

Tolerances and why:
- the shipped vocabulary loads to the same arrays in both packages;
- word ids exactly equal, on the descriptors of rendered frames and on
  random ones (integer distances, the first minimum taken by both); with
  the float vocabulary (anyfeat_nonbin, squared L2 summed in another
  order) equal except where a level's two smallest child distances lie
  within 1e-5 of each other;
- dense bow vectors within 1e-6 (float32 sums of the same idf weights in
  another order) and the database's sparse bows exactly equal;
- loop and relocalization candidate lists, minimum scores and
  covisibility groups exactly equal on the constructed loop map: the same
  numpy code on the same words;
- trained vocabularies' centroids and idf exactly equal (the same numpy
  k-means from the same seed; only the descent that assigns idf words is
  the port's).
"""

import functools
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu import native
from anyfeature_vslam_tpu.place_recognition import database as jdb
from anyfeature_vslam_tpu.place_recognition import vocab as jvoc
from anyfeature_vslam_tpu.slam.map_state import SlamMap as JaxMap
from anyfeature_vslam_tpu_torch.frontend.extractor import (ExtractorConfig, FeatureExtractor,
                                                           OrbExtractor)
from anyfeature_vslam_tpu_torch.place_recognition import database as tdb
from anyfeature_vslam_tpu_torch.place_recognition import dbow2_io as tdbow2
from anyfeature_vslam_tpu_torch.place_recognition import vocab as tvoc
from anyfeature_vslam_tpu_torch.slam.map_state import SlamMap as PortMap
from loop_map import build_loop_map, train_map_vocabulary
from torch_slice_scene import SliceScene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC = os.path.join(ROOT, "vocabularies", "voc_orb32_38k.npz")


@pytest.fixture(scope="module")
def vocabs():
    return jvoc.Vocabulary.load(VOC), tvoc.Vocabulary.load(VOC)


@pytest.fixture(scope="module")
def frame_descs():
    """orb32 descriptors of three rendered frames, 320x240, 600 features."""
    sc = SliceScene(320, 240)
    ext = OrbExtractor(ExtractorConfig(n_features=600), 240, 320)
    out = []
    for i in (0, 10, 20):
        f = ext(torch.from_numpy(sc.render(i)[0]).float())
        out.append((f["desc_bits"].numpy(), f["valid"].numpy()))
    return out


def test_shipped_vocabulary_loads_the_same(vocabs, tmp_path):
    jv, tv = vocabs
    assert (tv.branching, tv.depth, tv.n_words) == (jv.branching, jv.depth, jv.n_words) \
        == (14, 4, 38416)
    for a, b in zip(jv.centroids, tv.centroids):
        assert np.array_equal(a, b)
    assert np.array_equal(jv.idf, tv.idf)
    # a .txt path is a DBoW2 text vocabulary (tests/test_torch_dbow2_io.py)
    with pytest.raises(FileNotFoundError):
        tvoc.Vocabulary.load(str(tmp_path / "ORBvoc.txt"))
    path = str(tmp_path / "voc.txt")
    tdbow2.save_dbow2_text(tv, path)
    loaded = tvoc.Vocabulary.load(path)
    assert isinstance(loaded, tdbow2.Dbow2Vocabulary) and loaded.n_words == tv.n_words


def test_word_ids_equal_on_rendered_frames(vocabs, frame_descs):
    jv, tv = vocabs
    for bits, valid in frame_descs:
        want = np.asarray(jvoc.transform_words(jv, jnp.asarray(bits), jnp.asarray(valid)))
        got = tvoc.transform_words(tv, torch.from_numpy(bits), torch.from_numpy(valid)).numpy()
        assert (got >= 0).sum() > 100
        assert np.array_equal(got, want)


def test_word_ids_equal_on_random_and_tied_descriptors(vocabs):
    """Random bits, and descriptors equal to centroids' midpoints where two
    children tie: the first minimum must win in both."""
    jv, tv = vocabs
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (500, 256)).astype(np.uint8)
    c0 = jv.centroids[0]
    tie = np.where(rng.random((100, 256)) < 0.5, c0[0], c0[1]).astype(np.uint8)
    tie[:, c0[0] == c0[1]] = c0[0][c0[0] == c0[1]]
    for b in (bits, tie, c0):
        valid = np.ones(len(b), bool)
        valid[::7] = False
        want = np.asarray(jvoc.transform_words(jv, jnp.asarray(b), jnp.asarray(valid)))
        got = tvoc.transform_words(tv, torch.from_numpy(b), torch.from_numpy(valid)).numpy()
        assert np.array_equal(got, want)


def _near_tie_rows(vocab, desc, tol=1e-5):
    """Rows whose float64 descent meets, at some level, two children within
    tol of the smallest distance."""
    node = np.zeros(len(desc), np.int64)
    near = np.zeros(len(desc), bool)
    d = desc.astype(np.float64)
    for level in range(vocab.depth):
        cand = vocab.centroids[level][node[:, None] * vocab.branching
                                      + np.arange(vocab.branching)].astype(np.float64)
        dist = ((d[:, None, :] - cand) ** 2).sum(-1)
        two = np.sort(dist, axis=1)[:, :2]
        near |= two[:, 1] - two[:, 0] < tol
        node = node * vocab.branching + dist.argmin(1)
    return near


@pytest.mark.parametrize("feature", ["brisk48", "anyfeat_bin", "anyfeat_nonbin"])
def test_family_vocabularies_word_ids(feature):
    """The shipped vocabularies of the FAST families (branching 196, depth
    2; 384- and 512-bit binary, 48-d float) on the port's descriptors of
    two rendered frames."""
    path = os.path.join(ROOT, "vocabularies", f"voc_{feature}_38k.npz")
    jv, tv = jvoc.Vocabulary.load(path), tvoc.Vocabulary.load(path)
    assert (tv.branching, tv.depth) == (jv.branching, jv.depth) == (196, 2)
    ext = FeatureExtractor(ExtractorConfig.for_feature(feature, 600), 240, 320)
    sc = SliceScene(320, 240)
    for i in (0, 10):
        f = ext(torch.from_numpy(sc.render(i)[0]).float())
        desc, valid = f["desc_bits"].numpy(), f["valid"].numpy()
        assert desc.dtype == tv.centroids[0].dtype
        want = np.asarray(jvoc.transform_words(jv, jnp.asarray(desc), jnp.asarray(valid)))
        got = tvoc.transform_words(tv, torch.from_numpy(desc), torch.from_numpy(valid)).numpy()
        assert (got >= 0).sum() > 400
        if desc.dtype == np.uint8:
            assert np.array_equal(got, want)
        else:
            near = _near_tie_rows(tv, desc) & valid
            assert np.array_equal(got[~near], want[~near]) and near.sum() <= 5


def test_bow_vectors(vocabs, frame_descs):
    jv, tv = vocabs
    jd, td = jdb.KeyFrameDatabase(jv, 8), tdb.KeyFrameDatabase(tv, 8, device="cpu")
    for bits, valid in frame_descs:
        want = np.asarray(jvoc.bow_vector(jv, jnp.asarray(bits), jnp.asarray(valid)))
        got = tvoc.bow_vector(tv, torch.from_numpy(bits), torch.from_numpy(valid)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        a, b = jd.compute_bow(bits, valid), td.compute_bow(bits, valid)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    sa = np.asarray(jvoc.l1_score(jnp.asarray(want), jnp.asarray(np.stack([want, want * 0.5]))))
    sb = tvoc.l1_score(torch.from_numpy(want), torch.from_numpy(np.stack([want, want * 0.5])))
    np.testing.assert_allclose(sb.numpy(), sa, atol=1e-6, rtol=0)


def test_train_vocabulary_equal():
    rng = np.random.default_rng(1)
    descs = rng.integers(0, 2, (3000, 256)).astype(np.uint8)
    jv = jvoc.train_vocabulary(descs, branching=8, depth=2, iters=3, seed=2)
    tv = tvoc.train_vocabulary(descs, branching=8, depth=2, iters=3, seed=2)
    for a, b in zip(jv.centroids, tv.centroids):
        assert np.array_equal(a, b)
    assert np.array_equal(jv.idf, tv.idf)


def test_covisibility_matrix_matches_native():
    jm, _ = build_loop_map(JaxMap)
    want = native.covisibility_matrix(jm.kf_matches, jm.kf_valid, jm.max_pt)
    if want is None:
        pytest.skip("the JAX package's native library is not built")
    assert np.array_equal(tdb.covisibility_matrix(jm.kf_matches, jm.kf_valid, jm.max_pt), want)


@pytest.mark.parametrize("vocab_kind", ["shipped", "trained"])
def test_database_candidates_equal(vocabs, vocab_kind):
    """Both databases over the constructed loop map: loop candidates (with
    each keyframe's minimum covisible score), relocalization candidates for
    every keyframe's descriptors, and the covisibility groups."""
    jm, _ = build_loop_map(JaxMap)
    tm, _ = build_loop_map(functools.partial(PortMap, device="cpu"))
    if vocab_kind == "shipped":
        jv, tv = vocabs
    else:
        jv = train_map_vocabulary(jm, jvoc.train_vocabulary)
        tv = tvoc.Vocabulary(jv.branching, jv.depth, jv.centroids, jv.idf)
    jd, td = jdb.KeyFrameDatabase(jv, jm.max_kf), tdb.KeyFrameDatabase(tv, tm.max_kf, "cpu")
    n_loop = 0
    for kf in jm.keyframe_ids():
        kf = int(kf)
        bj = jd.compute_bow(jm.kf_desc_bits[kf], jm.kf_feat_valid[kf])
        bt = td.compute_bow(tm.kf_desc_bits[kf], tm.kf_feat_valid[kf])
        assert np.array_equal(bj[0], bt[0]) and np.array_equal(bj[1], bt[1])
        ms_j = jd.min_score_vs_covisibles(kf, jm, bow_q=bj)
        assert td.min_score_vs_covisibles(kf, tm, bow_q=bt) == ms_j
        cj = jd.detect_loop_candidates(kf, jm, ms_j, bow_q=bj)
        assert td.detect_loop_candidates(kf, tm, ms_j, bow_q=bt) == cj
        n_loop += len(cj)
        jd.add(kf, bow=bj)
        td.add(kf, bow=bt)
    assert n_loop > 0
    assert td._covis_groups(tm) == jd._covis_groups(jm)
    for kf in jm.keyframe_ids():
        want = jd.detect_relocalization_candidates(jm.kf_desc_bits[kf], jm.kf_feat_valid[kf], jm)
        got = td.detect_relocalization_candidates(torch.from_numpy(tm.kf_desc_bits[kf]),
                                                  torch.from_numpy(tm.kf_feat_valid[kf]), tm)
        assert got == want and int(kf) in got
    jm.remove_keyframe(5)
    jd.erase(5)
    tm.remove_keyframe(5)
    td.erase(5)
    assert np.array_equal(td.present, jd.present)
