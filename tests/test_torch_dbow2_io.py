"""DBoW2 text vocabularies of the PyTorch port against the JAX package
(place_recognition/dbow2_io.py), and the port's System on a .txt
vocabulary.

Tolerances and why:
- a file written by either package parses into equal arrays in both
  (exact), and both writers write the same text;
- binary words exactly equal to JAX's and to the native tree's: integer
  Hamming sums, the first child among equals, no rounding anywhere;
- a float vocabulary's words: >= 99% equal to JAX's (squared L2 summed
  in another order can pick the other child of a near-tie; 100% measured
  on 2000 queries);
- bow_vector within 1e-6 (float32 tf-idf sums);
- the System on the shipped orb32 tree written as DBoW2 text runs exactly
  as on the .npz tree: the same tree gives the same words, so every pose,
  count and database entry is equal.
"""

import os
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

from anyfeature_vslam_tpu.place_recognition import dbow2_io as jd
from anyfeature_vslam_tpu.place_recognition import vocab as jv
from anyfeature_vslam_tpu_torch import convert
from anyfeature_vslam_tpu_torch.frontend.extractor import ExtractorConfig, OrbExtractor
from anyfeature_vslam_tpu_torch.place_recognition import dbow2_io as td
from anyfeature_vslam_tpu_torch.place_recognition import vocab as tv
from anyfeature_vslam_tpu_torch.system import System
from torch_slice_scene import SliceScene

VOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "vocabularies",
                   "voc_orb32_38k.npz")
FIELDS = ("children", "node_desc", "leaf_word", "word_weight")
W, H, N_FEATURES, N_FRAMES = 320, 240, 600, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The shipped orb32 tree written as DBoW2 text by each package."""
    d = tmp_path_factory.mktemp("dbow2")
    native = tv.Vocabulary.load(VOC)
    paths = {"port": str(d / "port.txt"), "jax": str(d / "jax.txt")}
    td.save_dbow2_text(native, paths["port"])
    jd.save_dbow2_text(jv.Vocabulary.load(VOC), paths["jax"])
    return native, paths


@pytest.fixture(scope="module")
def frame_desc():
    """Real orb32 descriptors: one rendered frame's, extracted on the CPU."""
    sc = SliceScene(W, H)
    ext = OrbExtractor(ExtractorConfig(n_features=N_FEATURES), H, W)
    feats = ext(torch.from_numpy(sc.render(13)[0]).float())
    return feats["desc_bits"].numpy(), feats["valid"].numpy()


def _same_vocab(a, b):
    assert (a.branching, a.depth, a.fold, a.n_words) == (b.branching, b.depth, b.fold, b.n_words)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    np.testing.assert_array_equal(a.idf, b.idf)


def test_files_load_in_either_package(files):
    native, paths = files
    assert open(paths["port"]).read() == open(paths["jax"]).read()
    for path in paths.values():
        t = tv.Vocabulary.load(path)
        j = jv.Vocabulary.load(path)
        assert isinstance(t, td.Dbow2Vocabulary) and isinstance(j, jd.Dbow2Vocabulary)
        _same_vocab(t, j)
        _same_vocab(t, convert.dbow2_from_numpy(j))
        assert t.n_words == native.n_words == 38416 and t.depth == 4 and t.branching == 14
        # the leaves carry the native idf, as the file's weights
        np.testing.assert_array_equal(t.idf, native.idf)


def _words(desc, valid, vocabs):
    jvoc, tvoc, native = vocabs
    wj = np.asarray(jd.transform_words_dbow2(jvoc, jnp.asarray(desc), jnp.asarray(valid)))
    wt = td.transform_words_dbow2(tvoc, torch.from_numpy(desc), torch.from_numpy(valid)).numpy()
    wn = None if native is None else tv.transform_words(
        native, torch.from_numpy(desc), torch.from_numpy(valid)).numpy()
    return wj, wt, wn


def test_binary_words_equal_jax_and_native_tree(files, frame_desc):
    native, paths = files
    tvoc = tv.Vocabulary.load(paths["port"])
    jvoc = jd.load_dbow2_text(paths["port"])
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 2, (1000, 256)).astype(np.uint8)
    for desc, valid in (frame_desc, (rand, rng.random(1000) < 0.9)):
        wj, wt, wn = _words(desc, valid, (jvoc, tvoc, native))
        assert wt.dtype == np.int32
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_array_equal(wt, wn)
        assert (wt[~valid] == -1).all() and (wt[valid] >= 0).all()
    # tv.transform_words dispatches on the vocabulary's type
    desc, valid = frame_desc
    np.testing.assert_array_equal(
        tv.transform_words(tvoc, torch.from_numpy(desc), torch.from_numpy(valid)).numpy(),
        _words(desc, valid, (jvoc, tvoc, None))[0])


def test_folded_words_equal_jax(files, frame_desc):
    _, paths = files
    tvoc = td.load_dbow2_text(paths["port"], fold=1000)
    jvoc = jd.load_dbow2_text(paths["port"], fold=1000)
    assert tvoc.n_words == 1000
    np.testing.assert_array_equal(tvoc.idf, jvoc.idf)
    wj, wt, _ = _words(*frame_desc, (jvoc, tvoc, None))
    np.testing.assert_array_equal(wt, wj)


def test_unbalanced_tree(tmp_path):
    """tests/test_dbow2_io.py's hand-written file: a leaf at depth 1 beside
    an internal node with two leaves; the descent stays at the leaf."""
    d = lambda fill: " ".join(str(fill) for _ in range(32))  # noqa: E731
    lines = ["2 2 0 0", f"0 1 {d(0)} 0.5", f"0 0 {d(255)} 0", f"2 1 {d(254)} 0.7",
             f"2 1 {d(1)} 0.9"]
    path = tmp_path / "voc.txt"
    path.write_text("\n".join(lines) + "\n")
    tvoc = td.load_dbow2_text(str(path))
    jvoc = jd.load_dbow2_text(str(path))
    _same_vocab(tvoc, jvoc)
    rng = np.random.default_rng(1)
    desc = np.concatenate([np.zeros((1, 256), np.uint8), np.ones((1, 256), np.uint8),
                           rng.integers(0, 2, (300, 256)).astype(np.uint8)])
    valid = np.ones(len(desc), bool)
    wj, wt, _ = _words(desc, valid, (jvoc, tvoc, None))
    np.testing.assert_array_equal(wt, wj)
    assert wt[0] == 0 and wt[1] == 1


def test_float_vocabulary_words(tmp_path):
    rng = np.random.default_rng(2)
    train = rng.normal(size=(3000, 64)).astype(np.float32)
    native = tv.train_vocabulary(train, branching=8, depth=2, iters=4, seed=2)
    path = str(tmp_path / "float.txt")
    td.save_dbow2_text(native, path)
    tvoc = tv.Vocabulary.load(path)
    jvoc = jv.Vocabulary.load(path)
    _same_vocab(tvoc, jvoc)
    assert tvoc.node_desc.dtype == np.float32 and tvoc.n_words == 64
    q = rng.normal(size=(2000, 64)).astype(np.float32)
    wj, wt, _ = _words(q, np.ones(2000, bool), (jvoc, tvoc, None))
    assert (wt >= 0).all() and (wt == wj).mean() >= 0.99, (wt == wj).mean()


def test_bow_vector_matches_jax(files, frame_desc):
    _, paths = files
    tvoc = tv.Vocabulary.load(paths["jax"])
    jvoc = jv.Vocabulary.load(paths["jax"])
    desc, valid = frame_desc
    tb = tv.bow_vector(tvoc, torch.from_numpy(desc), torch.from_numpy(valid)).numpy()
    jb = np.asarray(jv.bow_vector(jvoc, jnp.asarray(desc), jnp.asarray(valid)))
    assert tb.shape == (38416,)
    np.testing.assert_allclose(tb, jb, atol=1e-6)
    assert abs(tb.sum() - 1.0) < 1e-5


def _run(vocabulary_path):
    sc = SliceScene(W, H)
    system = System(SimpleNamespace(**sc.camera), n_features=N_FEATURES, async_mapping=False,
                    vocabulary_path=vocabulary_path, device="cpu")
    states = [system.track_monocular(sc.render(i)[0], i / 30.0).name for i in range(N_FRAMES)]
    return system, states


def test_system_on_text_vocabulary_equals_npz(files):
    """A 12-frame synchronous System (loop detection at every event) on
    the .txt tree against the same System on the .npz tree."""
    _, paths = files
    a, sa = _run(VOC)
    b, sb = _run(paths["port"])
    assert isinstance(b.vocabulary, td.Dbow2Vocabulary) and b.vocabulary.n_words == 38416
    assert sa == sb and sa.count("OK") >= N_FRAMES - 2
    assert a.map.n_keyframes() == b.map.n_keyframes() >= 3
    kfs = a.map.keyframe_ids()
    np.testing.assert_array_equal(kfs, b.map.keyframe_ids())
    np.testing.assert_array_equal(a.map.kf_pose[kfs], b.map.kf_pose[kfs])
    np.testing.assert_array_equal(a.map.pt_pos[a.map.pt_valid], b.map.pt_pos[b.map.pt_valid])
    np.testing.assert_array_equal(a.database.present, b.database.present)
    np.testing.assert_array_equal(a.database.kf_words, b.database.kf_words)
    np.testing.assert_array_equal(a.database.kf_weights, b.database.kf_weights)
    assert len(a.loop_times) == len(b.loop_times) > 0
    assert a.loop_closer.n_loops_closed == b.loop_closer.n_loops_closed == 0
