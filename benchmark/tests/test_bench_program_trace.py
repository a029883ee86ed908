"""The per-layer metrics that read the program's own tracing: their
arithmetic on hand-built device lists and spans, nothing (and no error)
without the program's tracer, the program's valid-part counter against
the harness's reckoned part counts, and a traced run of each small cell
on the CPU, where the span metrics read and the device ones do not."""

import sys
import types

import pytest

from benchmark.harness import cell as harness_cell
from benchmark.harness import spec
from benchmark.tests import tiny

MS = 1_000_000  # ns


def _trace(device, span=(0, 100 * MS)):
    return types.SimpleNamespace(device=device, span=span)


def _rec(device, steps=2, span=(0, 100 * MS)):
    return {'trace': {'trace': _trace(device, span),
                      'batch_counts': [[2, 3]] * steps}}


def _span(name, start, end, **ids):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end,
                                 ids=ids)


@pytest.fixture
def program_spans(monkeypatch):
    """Hand the readers these spans as the program's record."""
    from multi_part_assembly_tpu_torch.utils import tracing
    kept = []
    monkeypatch.setattr(tracing, 'spans', lambda: list(kept))
    return kept


def _read(name, rec):
    return harness_cell.load_reader(name)(rec)


def test_mark_intervals_nest_and_sum_over_steps():
    mark = 'mpa_mark_{}'.format
    device = [
        (mark('encoder_begin'), 0, 1 * MS),
        (mark('masked_bn_begin'), 2 * MS, 3 * MS),
        ('elementwise_kernel', 3 * MS, 7 * MS),
        (mark('masked_bn_end'), 7 * MS, 8 * MS),
        (mark('encoder_end'), 9 * MS, 10 * MS),
        (mark('masked_bn_bwd_begin'), 20 * MS, 21 * MS),
        (mark('masked_bn_bwd_end'), 23 * MS, 24 * MS),
        (mark('matching_begin') + '()', 30 * MS, 31 * MS),
        (mark('lap_cost_begin') + '()', 31 * MS, 32 * MS),
        (mark('lap_cost_end') + '()', 36 * MS, 37 * MS),
        ('lap_kernel', 37 * MS, 38 * MS),
        (mark('matching_end') + '()', 38 * MS, 39 * MS),
        (mark('matching_begin'), 40 * MS, 41 * MS),
        (mark('lap_cost_begin'), 41 * MS, 42 * MS),
        (mark('lap_cost_end'), 43 * MS, 44 * MS),
        (mark('matching_end'), 44 * MS, 45 * MS),
    ]
    # masked_bn 4 ms and its backward 2 ms over 2 steps
    assert _read('masked_bn_ms', _rec(device)) == pytest.approx(3.0)
    # the LAP cost 4 ms and 1 ms, not the rest of the matching
    assert _read('lap_cost_ms', _rec(device)) == pytest.approx(2.5)
    # a region cut by the window counts its part inside
    assert _read('lap_cost_ms', _rec(device, span=(0, 34 * MS))) == \
        pytest.approx(1.0)
    plain = [('elementwise_kernel', 0, MS)]
    assert _read('masked_bn_ms', _rec(plain)) is None
    assert _read('lap_cost_ms', _rec(device[:7])) is None
    # the matching's marks alone are no LAP cost
    matching = [d for d in device if 'lap_cost' not in d[0]]
    assert _read('lap_cost_ms', _rec(matching)) is None


def test_flush_idle_subtracts_device_activity(program_spans):
    device = [('k', 10 * MS, 14 * MS), ('copy', 12 * MS, 16 * MS),
              ('k', 30 * MS, 31 * MS)]
    program_spans += [_span('train.flush', 10 * MS, 20 * MS),
                      _span('train.flush', 28 * MS, 32 * MS),
                      _span('train.flush', 200 * MS, 201 * MS),  # outside
                      _span('train.dispatch', 0, 40 * MS)]
    # idle 4 ms in the first, 3 ms in the second
    assert _read('flush_idle_ms', _rec(device)) == pytest.approx(3.5)
    assert _read('flush_idle_ms', _rec([])) is None
    program_spans.clear()
    assert _read('flush_idle_ms', _rec(device)) is None


def test_epoch_start_is_the_first_wait_of_the_window(program_spans):
    program_spans += [_span('data.wait', 0, 50 * MS, epoch=3, batch=0),
                      _span('data.wait', 110 * MS, 112 * MS, epoch=4,
                            batch=1),
                      _span('data.wait', 105 * MS, 109 * MS, epoch=4,
                            batch=0)]
    rec = _rec([], span=(100 * MS, 200 * MS))
    assert _read('epoch_start_ms', rec) == pytest.approx(4.0)
    program_spans.pop()
    assert _read('epoch_start_ms', rec) is None


def test_setup_data_is_the_union_before_the_window(program_spans):
    program_spans += [_span('setup.data', 0, 10 * MS),
                      _span('setup.tables', 20 * MS, 40 * MS),
                      _span('data.mesh_load', 25 * MS, 30 * MS),
                      _span('data.mesh_load', 60 * MS, 70 * MS),
                      _span('setup.capture', 10 * MS, 20 * MS),
                      _span('data.mesh_load', 120 * MS, 130 * MS)]
    rec = _rec([], span=(100 * MS, 200 * MS))
    assert _read('setup_data_s', rec) == pytest.approx(0.040)
    program_spans.clear()
    assert _read('setup_data_s', rec) is None


@pytest.mark.parametrize('name', ['flush_idle_ms', 'epoch_start_ms',
                                  'setup_data_s'])
def test_nothing_without_the_programs_tracer(name, monkeypatch):
    """A program without the tracer lacks the module: the reader reads None
    and raises nothing."""
    monkeypatch.setitem(sys.modules,
                        'multi_part_assembly_tpu_torch.utils.tracing', None)
    rec = _rec([('k', 0, MS)])
    assert _read(name, rec) is None


def _cell(cell, tmp_path, monkeypatch):
    monkeypatch.setattr(spec, 'CACHE', str(tmp_path))
    monkeypatch.setenv('MPA_MESH_CACHE_DIR', str(tmp_path / 'mesh'))
    config, traffic = tiny.CELLS[cell]
    cfg = tiny.config(config)
    cfg['exp']['bf16'] = False
    t = tiny.traffic(traffic)
    if t['wire'] == 'slot':  # 'auto' is on for CUDA only
        key = 'device_sampling' if t['data']['kind'] == 'geometry' \
            else 'device_table'
        t['options'] = {key: True}
        cfg['exp']['steps_per_call'] = 2
    return cfg, t


@pytest.mark.parametrize('cell', sorted(tiny.CELLS))
def test_valid_parts_match_the_reckoned_counts(cell, tmp_path, monkeypatch):
    from multi_part_assembly_tpu_torch.utils import tracing
    cfg, t = _cell(cell, tmp_path, monkeypatch)
    trainer, _, cfg_dict, _, _ = harness_cell.build(
        cfg, t, 2**31 + 3, 'cpu', str(tmp_path / 'ckp'))
    try:
        tracing.reset()
        trainer.train_epoch(1)
        counts = harness_cell.batch_counts(
            cfg_dict, harness_cell._items(cfg_dict), 1)
        c = tracing.counters()
        assert c['data.valid_parts'] == sum(map(sum, counts))
        P = int(cfg_dict['data']['max_num_part'])
        assert c['step.slots'] == len(counts) * len(counts[0]) * P
        assert c['data.batches'] == len(counts)
    finally:
        harness_cell.free(trainer)


@pytest.mark.parametrize('cell', sorted(tiny.CELLS))
def test_traced_cpu_run_reads_the_span_metrics(cell, tmp_path, monkeypatch):
    """On the CPU the program launches no marks and the trace has no device
    activity: the mark and idle metrics read nothing, the span ones read."""
    cfg, t = _cell(cell, tmp_path, monkeypatch)
    out = harness_cell.run(cfg, t, tiny.limits(cell), spec.per_layer(cell),
                           2**31 + 5, 0.2, True, device='cpu',
                           log=lambda m: None)
    got = out['metrics']
    assert got['epoch_start_ms']['value'] > 0
    assert got['setup_data_s']['value'] > 0
    for name in ('masked_bn_ms', 'lap_cost_ms', 'flush_idle_ms'):
        assert name not in got
