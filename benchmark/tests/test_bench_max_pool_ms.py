"""max_pool_ms: the PointNet's pool regions, forward and backward, summed
in ms a step on hand-built device lists; nothing (and no error) where the
program launches no pool marks, as a program without the pool kernels
does, and in a traced run on the CPU."""

import pytest

from benchmark.harness import cell as harness_cell
from benchmark.harness import spec
from benchmark.tests import tiny
from benchmark.tests.test_bench_program_trace import MS, _cell, _read, _rec


def test_max_pool_sums_both_regions_and_reads_none_without_marks():
    mark = 'mpa_mark_{}'.format
    device = [
        (mark('encoder_begin'), 0, 1 * MS),
        (mark('masked_bn_begin'), 1 * MS, 2 * MS),
        (mark('masked_bn_end'), 4 * MS, 5 * MS),
        (mark('max_pool_begin'), 5 * MS, 6 * MS),
        ('max_pool_kernel', 6 * MS, 9 * MS),
        (mark('max_pool_end'), 9 * MS, 10 * MS),
        (mark('encoder_end'), 10 * MS, 11 * MS),
        (mark('encoder_bwd_begin') + '()', 20 * MS, 21 * MS),
        (mark('max_pool_bwd_begin') + '()', 21 * MS, 22 * MS),
        ('max_pool_grad_kernel', 22 * MS, 27 * MS),
        (mark('max_pool_bwd_end') + '()', 27 * MS, 28 * MS),
        (mark('encoder_bwd_end') + '()', 30 * MS, 31 * MS),
    ]
    # the pool 3 ms and its backward 5 ms over 2 steps; not the batch norm
    assert _read('max_pool_ms', _rec(device)) == pytest.approx(4.0)
    assert _read('masked_bn_ms', _rec(device)) == pytest.approx(1.0)
    # the backward alone where the window holds only it
    assert _read('max_pool_ms', _rec(device, span=(15 * MS, 40 * MS))) == \
        pytest.approx(2.5)
    # a parent program: the encoder's marks, no pool's
    parent = [d for d in device if 'max_pool' not in d[0]]
    assert _read('max_pool_ms', _rec(parent)) is None
    assert _read('max_pool_ms', _rec([('elementwise_kernel', 0, MS)])) is None


def test_traced_cpu_run_leaves_max_pool_out(tmp_path, monkeypatch):
    """On the CPU the program launches no marks: the line has no
    max_pool_ms, and the reader raises nothing."""
    cell = sorted(tiny.CELLS)[0]
    cfg, t = _cell(cell, tmp_path, monkeypatch)
    per_layer = spec.per_layer(cell)
    assert 'max_pool_ms' in [m['name'] for m in per_layer]
    out = harness_cell.run(cfg, t, tiny.limits(cell), per_layer,
                           2**31 + 5, 0.2, True, device='cpu',
                           log=lambda m: None)
    assert 'max_pool_ms' not in out['metrics']
