"""The reference's K2 search against the port's plain twin on the CPU, and
the judge: the port's answers read no gap, altered answers and the
control (the search in TF32, float descriptors) read one."""

import math

import pytest
import torch

from anyfeature_vslam_tpu_torch.ops import cuda_match
from slambench.reference import search


def _call(binary: bool, nq=60, nc=80, d=None, seed=5):
    g = torch.Generator().manual_seed(seed)
    if binary:
        d = d or 256
        q = (torch.rand((nq, d), generator=g) < 0.5).to(torch.uint8)
        c = (torch.rand((nc, d), generator=g) < 0.5).to(torch.uint8)
    else:
        d = d or 128
        q = torch.rand((nq, d), generator=g)
        c = torch.rand((nc, d), generator=g)
        q, c = q / q.norm(dim=1, keepdim=True), c / c.norm(dim=1, keepdim=True)
    rad = torch.full((nq,), 30.0)
    rad[::7] = -1.0  # disabled rows
    return dict(q_feat=q, c_feat=c, q_uv=torch.rand((nq, 2), generator=g) * 100,
                c_uv=torch.rand((nc, 2), generator=g) * 100, q_rad=rad,
                q_slo=torch.full((nq,), 0.5), q_shi=torch.full((nq,), 2.0),
                c_size=torch.rand(nc, generator=g) * 2.0 + 0.3,
                c_valid=torch.rand(nc, generator=g) < 0.9)


def _port(call):
    args = [call[k] for k in ("q_feat", "c_feat", "q_uv", "c_uv", "q_rad", "q_slo", "q_shi",
                              "c_size", "c_valid")]
    return cuda_match.best_two(*args, c_dim=call.get("c_dim"))


@pytest.mark.parametrize("form", ["bits", "packed", "float", "float_prepared"])
def test_the_port_reads_no_gap_and_the_same_answers(form):
    call = _call(form in ("bits", "packed"))
    if form == "packed":
        call["c_dim"] = call["c_feat"].shape[1]
        call["c_feat"] = cuda_match.pack_bits(call["c_feat"])
    if form == "float_prepared":
        call["c_feat"] = cuda_match.prepare_float(call["c_feat"])
    best, idx, second = _port(call)
    g, n = search.gap(call, best, idx, second)
    assert n == 60
    if form in ("bits", "packed"):
        assert g == 0.0
    else:
        assert g < 1e-6
    r_best, r_idx, _ = search.search(call)
    assert torch.equal(r_idx, idx.to(torch.int64))
    assert (idx >= 0).sum() > 20 and (idx < 0).sum() >= 9


@pytest.mark.parametrize("binary", [True, False])
def test_an_altered_answer_reads_a_gap(binary):
    call = _call(binary)
    best, idx, second = _port(call)
    moved = idx.clone()
    j = int(torch.nonzero(idx >= 0)[0, 0])
    moved[j] = (idx[j] + 1) % call["c_feat"].shape[0]
    assert search.gap(call, best, moved, second)[0] > 1e-3
    dropped = idx.clone()
    dropped[j] = -1
    assert math.isinf(search.gap(call, best, dropped, second)[0])
    worse = second.clone()
    worse[j] += 1.0
    assert search.gap(call, best, idx, worse)[0] >= 1e-3


def test_the_control_reads_a_gap_on_floats_and_none_on_bits():
    call = _call(False, nq=200, nc=300)
    g_ref = search.gap(call, *_port(call))[0]
    g_ctl = search.gap(call, *search.search(call, "tf32"))[0]
    assert g_ctl > 30 * max(g_ref, 1e-7)
    bits = _call(True)
    assert search.gap(bits, *search.search(bits, "tf32"))[0] == 0.0


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13, -3.0 - 2 ** -12])
    assert search.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
