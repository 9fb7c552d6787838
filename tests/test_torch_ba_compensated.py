"""Compensated (two-float) normal-equation accumulation of the PyTorch port
(ops/ba.py: segment_sum_compensated, compensated=) against the JAX
package, on tests/test_ba_compensated.py's cases.

Tolerances, those tests/test_ba_compensated.py states:
- the adversarial sum (1e8 and 16383 ones in one segment) within 260 of
  the float64 oracle, plain float32 more than 4x further off; the
  multi-segment sum within 1e-4 of the oracle;
- the port's compensated sums equal JAX's exactly (the same partial sums
  in the same order, the same TwoSum scan);
- on the nominal problem the compensated solve's final cost is at most
  max(2 x the plain one, 1e-2), on the ill-conditioned one (low parallax,
  deep points, information weights over 1e6) at most 1.05 x the plain one
  + 1e-3, in each package and for the port's compensated cost against
  JAX's plain one;
- the compensated solves' poses within 1e-4 and points within 1e-3 of
  JAX's (float32 LM with other summation orders).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

from anyfeature_vslam_tpu.ops import ba as jba
from anyfeature_vslam_tpu_torch.ops import ba as tba
from test_ba_compensated import _final_cost, _make_problem

KEYS = ("obs_kf", "obs_pt", "obs_uv", "obs_w", "obs_valid")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def test_segment_sum_compensated_matches_f64_oracle():
    n = 16384
    ids = np.zeros(n, np.int32)
    vals = np.ones(n, np.float32)
    vals[0] = np.float32(1e8)
    oracle = 1e8 + (n - 1)
    plain = float(tba._seg_sum(torch.from_numpy(vals), torch.from_numpy(ids).long(), 2)[0])
    comp = float(tba.segment_sum_compensated(torch.from_numpy(vals), torch.from_numpy(ids), 2)[0])
    jcomp = float(np.asarray(jba.segment_sum_compensated(jnp.asarray(vals), jnp.asarray(ids),
                                                         2))[0])
    assert abs(comp - oracle) <= 260.0, (comp, plain)
    assert abs(plain - oracle) > 4 * abs(comp - oracle)
    assert comp == jcomp


@pytest.mark.parametrize("o,n_chunks", [(1000, 64), (1003, 64), (37, 8)])
def test_segment_sum_compensated_multi_segment_shapes(o, n_chunks):
    rng = np.random.default_rng(0)
    vals = rng.normal(0, 1, (o, 2, 3)).astype(np.float32)
    ids = rng.integers(0, 7, o).astype(np.int32)
    oracle = np.zeros((7, 2, 3), np.float64)
    np.add.at(oracle, ids, vals.astype(np.float64))
    comp = tba.segment_sum_compensated(torch.from_numpy(vals), torch.from_numpy(ids), 7,
                                       n_chunks=n_chunks).numpy()
    jcomp = np.asarray(jba.segment_sum_compensated(jnp.asarray(vals), jnp.asarray(ids), 7,
                                                   n_chunks=n_chunks))
    assert comp.shape == (7, 2, 3) and comp.dtype == np.float32
    np.testing.assert_allclose(comp, oracle, atol=1e-4)
    np.testing.assert_array_equal(comp, jcomp)


def _args(problem, to):
    poses_init, pts_init, free, obs, intr, *_ = problem
    return (to(poses_init), to(pts_init), to(free), *(to(obs[k]) for k in KEYS), *intr)


@pytest.fixture(scope="module")
def solves():
    """The CG solve (15 LM iterations, no Huber) on both problems, plain
    and compensated, in both packages: (poses, points, final cost)."""
    out = {}
    for deep in (False, True):
        prob = _make_problem(deep=deep)
        obs, intr = prob[3], prob[4]
        for comp in (False, True):
            p, x, _, _ = tba._bundle_adjust_impl(*_args(prob, torch.from_numpy), n_iters=15,
                                                 use_huber=False, compensated=comp)
            jp, jx, _, _ = jba._bundle_adjust_impl(*_args(prob, jnp.asarray), n_iters=15,
                                                   use_huber=False, compensated=comp)
            for pkg, (a, b) in (("torch", (p.numpy(), x.numpy())),
                                ("jax", (np.asarray(jp), np.asarray(jx)))):
                out[pkg, deep, comp] = (a, b, _final_cost(a, b, obs, intr))
    return out


def _cost(solves, *key):
    return solves[key][2]


def test_compensated_ba_matches_plain_on_nominal_problem(solves):
    for pkg in ("torch", "jax"):
        c_plain, c_comp = _cost(solves, pkg, False, False), _cost(solves, pkg, False, True)
        assert c_comp <= max(2.0 * c_plain, 1e-2), (pkg, c_plain, c_comp)
        assert _cost(solves, "torch", False, True) <= max(
            2.0 * _cost(solves, pkg, False, False), 1e-2)


def test_compensated_ba_on_ill_conditioned_problem(solves):
    """The cost of this problem moves by ~10% under last-bit changes of
    the poses (1e6 information weights): the port's and JAX's compensated
    solves end 2.4e-6 apart in the poses and 0.107 / 0.095 apart in the
    cost. So the cost bound is the file's, with either package's plain
    solve as the reference, and the states are held together."""
    for pkg in ("torch", "jax"):
        c_plain, c_comp = _cost(solves, pkg, True, False), _cost(solves, pkg, True, True)
        assert np.isfinite(c_comp)
        assert c_comp <= 1.05 * c_plain + 1e-3, (pkg, c_plain, c_comp)
        assert _cost(solves, "torch", True, True) <= 1.05 * _cost(solves, pkg, True, False) + 1e-3
    for deep in (False, True):
        tp, tx, _ = solves["torch", deep, True]
        jp, jx, _ = solves["jax", deep, True]
        np.testing.assert_allclose(tp, jp, atol=1e-4)
        np.testing.assert_allclose(tx, jx, atol=1e-3)


def test_compensated_option_takes_the_cg_path():
    """bundle_adjust(compensated=True) skips the dense solve (its problem
    is small enough for it) and equals the compensated CG solve;
    bundle_adjust_two_stage passes the option through."""
    prob = _make_problem(deep=True)
    args = _args(prob, torch.from_numpy)
    assert tba.uses_dense(args[0].shape[0], args[1].shape[0])
    want = tba._bundle_adjust_impl(*args, n_iters=5, compensated=True)
    got = tba.bundle_adjust(*args, n_iters=5, compensated=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dense = tba.bundle_adjust(*args, n_iters=5)
    assert not torch.equal(dense[0], got[0])
    two = tba.bundle_adjust_two_stage(*args, n_iters_a=3, n_iters_b=2, compensated=True)
    p, x, chi2, z = tba._bundle_adjust_impl(*args, n_iters=3, compensated=True)
    valid2 = args[7] & ~tba.classify_outliers(chi2, z)
    p, x, _, _ = tba._bundle_adjust_impl(p, x, *args[2:7], valid2, *args[8:], n_iters=2,
                                         use_huber=False, compensated=True)
    torch.testing.assert_close(two[0], p, rtol=0, atol=0)
    torch.testing.assert_close(two[1], x, rtol=0, atol=0)
