"""K1's and K2's bytes and operations at known shapes."""

import pytest
import torch

from slambench import roofline


def test_k1_on_a_flat_level_counts_no_live_pixel():
    lev = torch.full((48, 64), 40.0)
    assert roofline.k1_work([lev], 20.0) == (8 * 48 * 64, 35 * 48 * 64)


def test_k1_counts_the_arc_tests_where_a_corner_is_possible():
    lev = torch.zeros((48, 64))
    lev[20, 30] = 100.0          # all four cardinal ring points are darker
    nbytes, nops = roofline.k1_work([lev, torch.zeros((40, 53))], 20.0)
    assert nbytes == 8 * (48 * 64 + 40 * 53)
    assert nops == 35 * (48 * 64 + 40 * 53) + 162


def _side(nq, nc, rad):
    return (torch.zeros(nq, 2), torch.zeros(nc, 2), torch.full((nq,), rad), torch.zeros(nq),
            torch.full((nq,), 10.0), torch.ones(nc), torch.ones(nc, dtype=torch.bool))


def test_k2_binary_reads_packed_words_and_counts_the_pairs_that_pass():
    q = torch.zeros((2, 256), dtype=torch.uint8)
    c = torch.zeros((3, 256), dtype=torch.uint8)
    nbytes, ops = roofline.k2_work((q, c, *_side(2, 3, 5.0)), {})
    assert nbytes == 2 * 256 + 32 * 2 + 4 * 8 * 3 + 13 * 3
    # a +-1 dot product of 256 elements per pair on the int8 tensor cores
    assert ops == {"int8_tensor": 2 * 256 * 6, "cuda_core_instr": 8 * 6 + 4 * 6}
    # a negative radius disables the rows: only the gates' instructions are left
    assert roofline.k2_work((q, c, *_side(2, 3, -1.0)), {})[1] == {
        "int8_tensor": 0, "cuda_core_instr": 8 * 6}


def test_k2_float_counts_elements_norms_and_passes():
    q = torch.zeros((2, 128))
    rows = torch.zeros((3, 128))
    raw = roofline.k2_work((q, rows, *_side(2, 3, 5.0)), {})
    prepared = roofline.k2_work((q, (rows, torch.zeros(3)), *_side(2, 3, 5.0)), {})
    assert raw == (4 * 128 * 5 + 32 * 2 + 13 * 3,
                   {"tf32_tensor": 2 * 128 * 6, "cuda_core_instr": 8 * 6 + 4 * 6 + 128 * 5})
    assert prepared[0] == raw[0] + 4 * 3
    assert prepared[1] == {"tf32_tensor": 2 * 128 * 6, "cuda_core_instr": 8 * 6 + 4 * 6 + 128 * 2}


def test_least_time_is_the_slowest_unit():
    assert roofline.least_s(3.35e12, {}) == pytest.approx(1.0)
    assert roofline.least_s(0, {"cuda_core_instr": 33.5e12}) == pytest.approx(1.0)
    assert roofline.least_s(0, {"cuda_core_instr": 33.5e12,
                                "int8_tensor": 2 * 1979e12}) == pytest.approx(2.0)
    assert roofline.k2_work((torch.zeros((0, 256), dtype=torch.uint8),
                             torch.zeros((3, 256), dtype=torch.uint8), *_side(0, 3, 5.0)),
                            {}) is None
