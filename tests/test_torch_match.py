"""Kernel K2's plain twin (masked best/second) and the matching core of the
PyTorch port against the JAX package: its jnp ``reference_best_two`` and
the Pallas ``fused_best_two`` in interpret mode, on the cases of
tests/test_pallas_match.py.

Tolerances: binary (Hamming) distances are small integers computed
exactly on both sides, so best, index and second must be equal. Float
(squared L2) distances are fp32 sums in another order: rtol 1e-4,
atol 1e-2, as tests/test_pallas_match.py states. The acceptance tests
(threshold, unique, rotation histogram) are integer logic on equal inputs:
equal results.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anyfeature_vslam_tpu.ops import matching as jmatch
from anyfeature_vslam_tpu.ops import pallas_match as jpm
from anyfeature_vslam_tpu_torch.ops import cuda_match
from anyfeature_vslam_tpu_torch.ops import matching as tmatch


def _case(rng, nq, nc, binary, dim=256):
    if binary:
        q = rng.integers(0, 2, (nq, dim)).astype(np.uint8)
        c = rng.integers(0, 2, (nc, dim)).astype(np.uint8)
    else:
        q = rng.normal(size=(nq, dim)).astype(np.float32)
        c = rng.normal(size=(nc, dim)).astype(np.float32)
    q_uv = rng.uniform(0, 640, (nq, 2)).astype(np.float32)
    c_uv = rng.uniform(0, 640, (nc, 2)).astype(np.float32)
    q_rad = rng.uniform(30, 200, nq).astype(np.float32)
    q_slo = np.full(nq, 0.0, np.float32)
    q_shi = np.full(nq, 1e9, np.float32)
    c_size = rng.uniform(1, 3, nc).astype(np.float32)
    c_valid = rng.random(nc) < 0.9
    return [q, c, q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid]


def _port(args):
    return [t.numpy() for t in cuda_match.reference_best_two(*map(torch.from_numpy, args))]


def _jax(args, fused=False):
    jargs = list(map(jnp.asarray, args))
    if fused:
        out = jpm.fused_best_two(*jargs, tile_q=128, tile_c=256, interpret=True)
    else:
        out = jpm.reference_best_two(*jargs)
    return [np.asarray(o) for o in out]


def _assert_same(got, want, binary):
    b, i, s = got
    wb, wi, ws = want
    np.testing.assert_array_equal(i, wi)
    if binary:
        np.testing.assert_array_equal(b, wb)
        np.testing.assert_array_equal(s, ws)
    else:
        np.testing.assert_allclose(b, wb, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(s, ws, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("nq,nc", [(100, 300), (256, 512), (300, 700)])
def test_reference_best_two_matches_jax(binary, nq, nc):
    args = _case(np.random.default_rng(0 if binary else 1), nq, nc, binary)
    got = _port(args)
    _assert_same(got, _jax(args), binary)
    _assert_same(got, _jax(args, fused=True), binary)


def test_gates_size_band_no_candidate_negative_radius():
    rng = np.random.default_rng(2)
    args = _case(rng, 64, 128, True)
    args[4][:] = 1e9
    args[4][:8] = -1.0                    # disabled query rows
    args[5][:] = 1.5                      # size band [1.5, 2.0]
    args[6][:] = 2.0
    got = _port(args)
    _assert_same(got, _jax(args), True)
    _assert_same(got, _jax(args, fused=True), True)
    b, i, s = got
    assert (i[:8] == -1).all() and (b[:8] == tmatch.INF).all() and (s[:8] == tmatch.INF).all()
    ok = i >= 0
    assert ok.any()
    assert ((args[7][i[ok]] >= 1.5) & (args[7][i[ok]] <= 2.0)).all()
    args[8][:] = False                    # no valid candidate at all
    b, i, s = _port(args)
    assert (i == -1).all() and (b == tmatch.INF).all()


def test_binary_ties_take_lowest_index():
    rng = np.random.default_rng(3)
    args = _case(rng, 40, 96, True)
    for k in (1, 3, 7, 8):                # every candidate twice: exact ties
        args[k][48:] = args[k][:48]
    args[4][:] = 1e9
    got = _port(args)
    _assert_same(got, _jax(args), True)
    _assert_same(got, _jax(args, fused=True), True)
    b, i, s = got
    assert (i < 48).all() and (s == b).all()


def test_wrapper_uses_twin_on_cpu_without_launching():
    args = list(map(torch.from_numpy, _case(np.random.default_rng(4), 50, 80, True)))
    b, i, s = cuda_match.best_two(*args)
    rb, ri, rs = cuda_match.reference_best_two(*args)
    assert i.dtype == torch.int32
    assert torch.equal(b, rb) and torch.equal(i.long(), ri) and torch.equal(s, rs)
    assert cuda_match.best_two.launches == 0


def test_wrapper_refuses_other_devices():
    args = [torch.empty((4, 256), dtype=torch.uint8, device="meta")] * 2
    with pytest.raises(ValueError):
        cuda_match.best_two(*args, *[None] * 7)


def test_hamming_and_best_two_match_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2, (70, 256)).astype(np.uint8)
    b = rng.integers(0, 2, (90, 256)).astype(np.uint8)
    want = np.asarray(jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tmatch.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    mask = rng.random(want.shape) < 0.3
    jb = [np.asarray(x) for x in jmatch.best_two(jnp.asarray(want), jnp.asarray(mask))]
    tb = [x.numpy() for x in tmatch.best_two(torch.from_numpy(got), torch.from_numpy(mask))]
    for x, y in zip(tb, jb):
        np.testing.assert_array_equal(x, y)


def _forced_ties(rng, n=300, n_cand=40):
    """Queries claiming few candidates with repeated distances, and angles
    whose rotation differences sit on histogram bin centres and edges."""
    idx = rng.integers(-1, n_cand, n).astype(np.int32)
    best = rng.integers(0, 6, n).astype(np.float32) * 10.0
    second = best + rng.integers(0, 4, n).astype(np.float32) * 5.0
    step = 2 * np.pi / 30
    angle_q = (rng.integers(0, 30, n) * step + rng.choice([0.0, 0.5 * step], n)).astype(np.float32)
    angle_q = np.where(angle_q > np.pi, angle_q - 2 * np.pi, angle_q).astype(np.float32)
    angle_c = rng.uniform(-np.pi, np.pi, n_cand).astype(np.float32)
    angle_c[:10] = 0.0
    return idx, best, second, angle_q, angle_c


@pytest.mark.parametrize("variant", ["plain", "ratio", "rotation", "ratio_rotation"])
def test_finish_match_with_forced_ties(variant):
    rng = np.random.default_rng(6)
    idx, best, second, angle_q, angle_c = _forced_ties(rng)
    kw = {}
    if "ratio" in variant:
        kw["ratio"] = 0.8
    j_kw, t_kw = dict(kw), dict(kw)
    if "rotation" in variant:
        j_kw.update(angle_q=jnp.asarray(angle_q), angle_c=jnp.asarray(angle_c))
        t_kw.update(angle_q=torch.from_numpy(angle_q), angle_c=torch.from_numpy(angle_c))
    want = jmatch.finish_match(jnp.asarray(best), jnp.asarray(idx), jnp.asarray(second),
                               40, 45.0, **j_kw)
    got = tmatch.finish_match(torch.from_numpy(best), torch.from_numpy(idx),
                              torch.from_numpy(second), 40, 45.0, **t_kw)
    for k in ("idx", "dist", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert 0 < got["valid"].sum() < len(idx)


def test_resolve_unique_and_rotation_consistency_with_ties():
    rng = np.random.default_rng(7)
    idx, best, _, angle_q, angle_c = _forced_ties(rng)
    idx = np.maximum(idx, 0)
    valid = rng.random(len(idx)) < 0.8
    want = jmatch.resolve_unique(jnp.asarray(idx), jnp.asarray(best), jnp.asarray(valid), 40)
    got = tmatch.resolve_unique(torch.from_numpy(idx).long(), torch.from_numpy(best),
                                torch.from_numpy(valid), 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jmatch.rotation_consistency(jnp.asarray(angle_q), jnp.asarray(angle_c),
                                       jnp.asarray(idx), jnp.asarray(valid))
    got = tmatch.rotation_consistency(torch.from_numpy(angle_q), torch.from_numpy(angle_c),
                                      torch.from_numpy(idx).long(), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dim", [256, 384, 488, 512])
def test_pack_bits_twin_is_little_endian_words(dim):
    bits = np.random.default_rng(dim).integers(0, 2, (37, dim)).astype(np.uint8)
    nwords = (dim + 31) // 32
    padded = np.zeros((37, nwords * 32), np.uint8)
    padded[:, :dim] = bits
    want = np.packbits(padded, axis=1, bitorder="little").view("<u4")
    got = cuda_match.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32 and got.shape == (37, nwords)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    if dim == 488:  # 15.25 words: the last word holds 8 bits, the tail is zero
        assert (got.numpy().view(np.uint32)[:, -1] >> 8 == 0).all()
    np.testing.assert_array_equal(cuda_match.unpack_bits_plain(got, dim).numpy(), bits)
    assert cuda_match.pack_bits.launches == 0


@pytest.mark.parametrize("dim", [256, 384, 488, 512])
def test_best_two_with_packed_candidates_is_exact(dim):
    args = _case(np.random.default_rng(dim), 120, 333, True, dim=dim)
    c = args[1]
    c[200:] = c[:133]                     # duplicated rows: exact ties
    targs = list(map(torch.from_numpy, args))
    words = cuda_match.pack_bits(targs[1])
    packed = cuda_match.best_two(targs[0], words, *targs[2:], c_dim=dim)
    plain = cuda_match.best_two(*targs)
    for x, y in zip(packed, plain):
        assert torch.equal(x, y)
    _assert_same([t.numpy() for t in packed], _jax(args), True)
    assert cuda_match.best_two.launches == 0


def test_guided_best_two_takes_words_in_place_of_candidates():
    args = list(map(torch.from_numpy, _case(np.random.default_rng(8), 60, 90, True)))
    words = cuda_match.pack_bits(args[1])
    got = tmatch.guided_best_two(*args, c_words=words)
    want = tmatch.guided_best_two(*args)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):      # packed words of another width
        cuda_match.best_two(args[0], words, *args[2:], c_dim=384)
    with pytest.raises(ValueError):      # bit planes where words are expected
        cuda_match.best_two(args[0], args[1], *args[2:], c_dim=256)


# ------------------------------------------------- prepared float candidates

def _unit_case(rng, nq, nc, dim):
    """Float descriptors of unit length, as the learned48 rows are."""
    args = _case(rng, nq, nc, False, dim=dim)
    for k in (0, 1):
        args[k] /= np.linalg.norm(args[k], axis=1, keepdims=True)
    return args


def _equal(got, want):
    for x, y in zip(got, want):
        assert torch.equal(x.to(y.dtype), y)


@pytest.mark.parametrize("dim", [48, 64, 128])
def test_float_prepared_set_equals_raw_rows_and_jax(dim):
    args = _unit_case(np.random.default_rng(dim), 90, 200, dim)
    targs = list(map(torch.from_numpy, args))
    fs = cuda_match.pack_candidates(targs[1])
    assert isinstance(fs, cuda_match.FloatSet)
    assert torch.equal(fs.rows, targs[1])
    # the twin's own norms (matching.l2sq_matrix), bit for bit
    assert torch.equal(fs.norms, torch.sum(targs[1] * targs[1], dim=-1))
    raw = cuda_match.reference_best_two(*targs)
    _equal(cuda_match.reference_best_two(targs[0], fs, *targs[2:]), raw)
    _equal(cuda_match.best_two(targs[0], fs, *targs[2:]), raw)
    _equal(tmatch.guided_best_two(*targs, c_words=fs), raw)
    got = [t.numpy() for t in raw]
    assert (got[1] >= 0).sum() > 40
    _assert_same(got, _jax(args), False)
    _assert_same(got, _jax(args, fused=True), False)
    assert cuda_match.best_two.launches == 0


def test_float_ties_take_lowest_index_in_both_packages():
    rng = np.random.default_rng(9)
    args = _unit_case(rng, 40, 96, 48)
    for k in (1, 3, 7, 8):                # every candidate twice: exact ties
        args[k][48:] = args[k][:48]
    args[4][:] = 1e9
    targs = list(map(torch.from_numpy, args))
    fs = cuda_match.pack_candidates(targs[1])
    got = [t.numpy() for t in cuda_match.best_two(targs[0], fs, *targs[2:])]
    _assert_same(got, _jax(args), False)
    _assert_same(got, _jax(args, fused=True), False)
    b, i, s = got
    assert (i >= 0).all() and (i < 48).all() and (s == b).all()


@pytest.mark.parametrize("fault", ["width", "norm_count", "row_dtype", "norm_dtype",
                                   "binary_queries"])
def test_inconsistent_float_set_raises(fault):
    targs = list(map(torch.from_numpy, _unit_case(np.random.default_rng(10), 20, 50, 64)))
    rows, norms = cuda_match.pack_candidates(targs[1])
    q = targs[0]
    if fault == "width":
        fs = cuda_match.FloatSet(rows[:, :48].contiguous(), norms)
    elif fault == "norm_count":
        fs = cuda_match.FloatSet(rows, norms[:-1])
    elif fault == "row_dtype":
        fs = cuda_match.FloatSet(rows.double(), norms)
    elif fault == "norm_dtype":
        fs = cuda_match.FloatSet(rows, norms.double())
    else:
        fs = cuda_match.FloatSet(rows, norms)
        q = (q > 0).to(torch.uint8)
    with pytest.raises(ValueError):
        cuda_match.best_two(q, fs, *targs[2:])
    with pytest.raises(ValueError):
        tmatch.guided_best_two(q, targs[1], *targs[2:], c_words=fs)
