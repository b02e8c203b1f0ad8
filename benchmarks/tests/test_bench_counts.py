"""The byte and operation counts against hand-worked values."""
from __future__ import annotations

import pytest

from benchmarks import counts


def test_k1_launch_over_a_whole_pass():
    # 10 minutes and a quarter second at 2.048 Msps, stride 34, 151 taps
    n = 1_229_312_000
    out_len = -(-n // 34)                    # 36,156,236 outputs
    b, ops = counts.k1_launch_raw(n, 34, 151)
    assert out_len == 36_156_236
    assert b == 2 * n + 4 * out_len + 8 == 2_603_248_952
    assert ops == out_len * (8 * 151 + 12) == 44_110_607_920
    # bytes bound it: 2.603 GB / 3.35 TB/s = 0.7771 ms; ops 0.6584 ms
    assert counts.least_seconds(b, ops) == pytest.approx(2_603_248_952 / 3.35e12)


def test_k3_symbols():
    b, ops = counts.k3_symbols(7_200_000)
    assert (b, ops) == (216_000_000, 720_000_000)
    # 64.5 us of bytes against 10.7 us of operations
    assert counts.least_seconds(b, ops) == pytest.approx(216e6 / 3.35e12)


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert counts.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)
