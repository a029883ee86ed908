"""The roofline arithmetic copied into the benchmark against
`chip_smoke.py`'s, for a fixed part mix."""

import chip_smoke as smoke
import pytest

from benchmark.harness import roofline

MIX = [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 10, 12, 16, 20] * 2


def test_peaks_are_the_smoke_s():
    assert (roofline.PEAK_OPS, roofline.PEAK_BYTES, roofline.PAIR_OPS) == \
        (smoke.PEAK_OPS, smoke.PEAK_BYTES, smoke.PAIR_OPS)


@pytest.mark.parametrize('diagonal', [False, True])
def test_pair_bound_is_the_smoke_s(diagonal):
    N, P, B = smoke.N, smoke.P, len(MIX)
    pairs = sum(n * N * N if diagonal else (n * N) ** 2 for n in MIX)
    ms, by = smoke._pair_bound(pairs, B)
    s, by2 = roofline.pair_bound_s(pairs, B, P, N)
    assert s * 1e3 == pytest.approx(ms, rel=1e-12) and by == by2


@pytest.mark.parametrize('need_dy', [False, True])
def test_grad_bound_is_the_smoke_s(need_dy):
    N, P, B = smoke.N, smoke.P, len(MIX)
    valid = sum(MIX) * N
    point, padded = (64, 24) if need_dy else (52, 12)
    ms, _ = smoke._bound(nbytes=point * valid + padded * (B * P * N - valid))
    s, by = roofline.grad_bound_s(valid, B, P, N, need_dy=need_dy)
    assert s * 1e3 == pytest.approx(ms, rel=1e-12) and by == 'bytes'


def test_everyday_b1_bound_is_perf_md_s():
    """PERF.md's table: B1 at the everyday mix, batch 32, 2.304e9 pairs,
    bound 0.6878 ms by operations."""
    s, by = roofline.pair_bound_s(2.304e9, 32, 20, 1000)
    assert round(s * 1e3, 4) == 0.6878 and by == 'operations'


def test_step_bound_adds_both_chamfers_and_their_gradients():
    P, N = 20, 1000
    counts = [3, 5]
    one = (roofline.pair_bound_s(9e6 + 25e6, 2, P, N)[0]
           + roofline.pair_bound_s(8 * N * N, 2, P, N)[0]
           + 2 * roofline.grad_bound_s(8 * N, 2, P, N)[0])
    assert roofline.chamfer_step_bound_s(counts, P, N, 5) == \
        pytest.approx(5 * one, rel=1e-12)
