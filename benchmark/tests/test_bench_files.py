"""Every file the harness finds by name parses, and BENCHMARK.json keeps to
the shapes its readers rely on: names and units of the allowed
characters, one-line reasons, a file for each configuration, traffic,
cell and per-layer metric."""

import importlib.util
import json
import os
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
B = spec.benchmark_json()


def _line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys():
    assert set(B) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert B['paths'] == ['benchmark']
    assert B['command'][1] == 'benchmark/run.py'
    assert 1 <= B['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, 'BENCHMARK.json')) < 65536


def test_names_units_and_reasons():
    names = []
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for e in B[group]:
            assert NAME.match(e['name']), e['name']
            names.append((group, e['name']))
            if 'unit' in e:
                assert UNIT.match(e['unit']), e['unit']
                assert e['better'] in ('lower', 'higher')
            for key in ('why', 'layer', 'source'):
                if key in e:
                    assert _line(e[key]), (e['name'], key)
    assert len(names) == len(set(names))


def test_configs_have_their_files():
    for c in B['configs']:
        path = os.path.join(spec.ROOT, c['file'])
        assert c['file'].startswith('benchmark/configs/')
        with open(path) as f:
            cfg = json.load(f)
        assert cfg['source'] == c['source'] and cfg['reduced'] == c['reduced']
        assert all(NAME.match(k) for k in c['reduced'])
        for section in spec.SECTIONS:
            assert isinstance(cfg[section], dict)


@pytest.mark.parametrize('cell', [w['name'] for w in B['workloads']])
def test_cells_have_their_files(cell):
    w, config, traffic, wfile = spec.cell(cell)
    assert w['chips'] in (1, 4) and NAME.match(w['traffic'])
    assert traffic['wire'] in ('slot', 'host')
    assert traffic['data']['kind'] in ('geometry', 'partnet')
    assert {'loss_gap', 'change_gap'} <= set(wfile['limits']) <= {
        'loss_gap', 'later_loss_gap', 'grad_gap', 'change_gap'}
    assert all(v > 0 for v in wfile['limits'].values())
    reported = spec.per_layer(cell)
    assert reported, 'a cell reports at least one per-layer metric'


def test_per_layer_metrics_have_readers():
    e2e = {m['name'] for m in B['end_to_end']}
    cells = {w['name'] for w in B['workloads']}
    assert 'setup_s' in e2e
    for m in B['per_layer']:
        assert m['moves'] in e2e
        assert set(m.get('workloads', [])) <= cells
        path = os.path.join(spec.BENCH_DIR, 'metrics', f"{m['name']}.py")
        mod_spec = importlib.util.spec_from_file_location('m', path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        assert callable(mod.read)
    for m in B['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0 < m['bound'] <= 0.25


def test_layers_named_alike():
    layers = {m['layer'] for m in B['per_layer']}
    assert layers <= {'host data', 'dispatch', 'train step', 'kernels'}
