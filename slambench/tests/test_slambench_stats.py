"""The metrics' arithmetic."""

import pytest

from slambench import stats


def test_a_rate_counts_the_whole_window_its_drain_included():
    # 100 frames handed over in 50 s, then a 2 s drain
    assert stats.rate(100, 10.0, 62.0) == pytest.approx(100 / 52.0)


def test_the_p90_is_taken_over_all_frames_not_medians_of_chunks():
    # every tenth-to-fifth frame meets a keyframe event
    lat = ([100.0] * 8 + [900.0] * 2) * 10
    assert stats.percentile(lat, 90) == 900.0
    chunks = [stats.median(lat[k:k + 10]) for k in range(0, 100, 10)]
    assert stats.percentile(chunks, 90) == 100.0
    assert stats.percentile(list(range(1, 101)), 90) == 90
    assert stats.percentile([5.0], 90) == 5.0


def test_the_union_of_kernel_intervals_and_its_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert stats.union(iv) == [(0, 3), (5, 6), (8, 9)]
    assert stats.busy(iv) == pytest.approx(5.0)
    assert stats.gaps(iv, -1, 10) == [(-1, 0), (3, 5), (6, 8), (9, 10)]
    assert stats.gaps([], 0, 4) == [(0, 4)]
