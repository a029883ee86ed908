"""The port's harness scripts on a tiny CPU run: scripts/print_cfg_torch.py,
vis_torch.py, collect_test_torch.py and profile_summary_torch.py on the
checkpoint and the trace of a `train_torch.py --profile` run, and the
syntax of scripts/gpu_run.sh."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'scripts'))
FLAGSHIP = os.path.join(ROOT, 'configs/pn_transformer/pn_transformer/'
                        'pn_transformer-32x1-cosine_400e-everyday.py')
OPTS = ['model.pc_feat_dim', '16', 'model.transformer_feat_dim', '32',
        'model.transformer_heads', '4', 'model.transformer_layers', '1',
        'data.max_num_part', '5', 'data.num_pc_points', '16',
        'exp.batch_size', '2', 'exp.bf16', 'False']


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """A tiny flagship run on the CPU: 2 epochs, a checkpoint each, and a
    torch.profiler trace of one more epoch.  Yields (data dir, run dir,
    the category of the set), its mesh cache in a directory of its own."""
    import train_torch
    from make_synthetic_data import generate
    tmp = tmp_path_factory.mktemp('harness')
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPA_MESH_CACHE_DIR', str(tmp / 'mesh_cache'))
        data = generate(str(tmp / 'bb'), n_shapes=4, min_parts=2,
                        max_parts=4, seed=0)
        run_dir = str(tmp / 'run')
        train_torch.main([
            '--cfg_file', FLAGSHIP, '--device', 'cpu', '--ckp_dir', run_dir,
            '--profile', os.path.join(run_dir, 'profile'), '--opts',
            'data.data_dir', data, 'exp.num_epochs', '2', 'exp.val_every',
            '1', *OPTS])
        category = sorted(d for d in os.listdir(data)
                          if os.path.isdir(os.path.join(data, d)))[0]
        yield data, run_dir, category


def test_print_cfg_torch(capsys):
    import print_cfg_torch
    cfg = print_cfg_torch.main(['--cfg_file', FLAGSHIP, '--opts',
                                'exp.batch_size', '16'])
    out = capsys.readouterr().out
    assert cfg.model.name == 'pn_transformer' and cfg.exp.batch_size == 16
    assert 'pn_transformer' in out and 'transformer_feat_dim' in out


def test_vis_torch_exports_ranked_samples(run, tmp_path):
    """The best 2 val shapes, each with its part meshes in three poses,
    their sampled clouds, and the three coloured assembly clouds."""
    import vis_torch
    data, run_dir, _ = run
    out = str(tmp_path / 'vis')
    dirs = vis_torch.main([
        '--cfg_file', FLAGSHIP, '--device', 'cpu', '--weight',
        os.path.join(run_dir, 'models', '1'), '--vis', '2', '--out_dir', out,
        '--opts', 'data.data_dir', data, *OPTS])
    assert len(dirs) == 2
    for d in dirs:
        files = os.listdir(d)
        meshes = [f for f in files if f.endswith('.obj') and
                  not f.startswith(('input_', 'pred_'))]
        assert meshes
        for m in meshes:
            for name in (f'input_{m}', f'pred_{m}', f'input_{m[:-4]}.ply',
                         f'pred_{m[:-4]}.ply'):
                assert name in files, (d, name)
        for tag in ('pred', 'gt', 'input'):
            assert f'assembly_{tag}.ply' in files


def test_collect_test_torch(run, capsys):
    """The run's newest checkpoint tested on the set's category: the
    trainer's test metrics, and the LaTeX rows."""
    import collect_test_torch
    data, run_dir, category = run
    per_cat = collect_test_torch.main([
        '--cfg_file', FLAGSHIP, '--device', 'cpu', '--ckp_dirs', run_dir,
        '--category', category, '--opts', 'data.data_dir', data, *OPTS])
    assert list(per_cat) == [category]
    res = per_cat[category]
    assert 0.0 <= res['test/part_acc'] <= 1.0
    assert all(np.isfinite(v) for v in res.values())
    out = capsys.readouterr().out
    assert f'{category} & ' in out and 'mean & ' in out


def test_profile_summary_torch_on_a_cpu_trace(run, capsys):
    """A CPU run's trace has host operators and no device event: the
    device time is reported as not measured."""
    import profile_summary_torch
    _, run_dir, _ = run
    s = profile_summary_torch.main([os.path.join(run_dir, 'profile'),
                                    '--host', '--top', '5'])
    out = capsys.readouterr().out
    assert s['idle_share'] is None and s['kernels'] == []
    assert 'not measured' in out
    assert len(s['host']) == 5 and all(d > 0 for _, d, _ in s['host'])


def test_profile_summary_torch_counts_device_time():
    """Device time and launches per kernel, and the idle share of the
    window from the first kernel to the end of the last, overlaps counted
    once."""
    from profile_summary_torch import summarize
    events = [
        {'ph': 'X', 'cat': 'kernel', 'name': 'a', 'ts': 0, 'dur': 10},
        {'ph': 'X', 'cat': 'kernel', 'name': 'b', 'ts': 5, 'dur': 10},
        {'ph': 'X', 'cat': 'kernel', 'name': 'a', 'ts': 30, 'dur': 10},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD', 'ts': 20,
         'dur': 2},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mm', 'ts': 0,
         'dur': 100},
    ]
    s = summarize(events)
    assert s['kernels'][0] == ('a', 20.0, 2)
    assert ('b', 10.0, 1) in s['kernels']
    assert s['span_us'] == 40.0 and s['busy_us'] == 27.0
    assert s['idle_share'] == pytest.approx(13.0 / 40.0)


CPU_PROFILER_CLOCK_US = 5000


def test_profile_writes_the_programs_spans(run, capsys):
    """The `--profile` epoch's own spans of every thread and its counters
    beside the trace, on the trace's clock; the summary lists them."""
    import json

    import profile_summary_torch
    _, run_dir, _ = run
    folder = os.path.join(run_dir, 'profile')
    with open(os.path.join(folder, 'spans.json')) as f:
        record = json.load(f)
    names = {s['name'] for s in record['spans']}
    assert {'data.collate', 'data.place', 'data.wait', 'data.epoch_start',
            'train.dispatch', 'train.flush'} <= names
    assert record['counters']['data.batches'] == 2
    assert record['counters']['step.slots'] == 2 * 2 * 5
    spans = profile_summary_torch.load_spans(folder)
    events = profile_summary_torch.load_events(folder)
    dispatch = [e for e in events if e['name'] == 'train.dispatch']
    ours = [s for s in spans if s['name'] == 'train.dispatch']
    assert len(dispatch) == len(ours) == 2
    # one clock: the span and its profiler range agree up to the CPU
    # profiler's conversion of its own clock to Unix time, which swings by
    # up to about 1 ms against time.time_ns() (on the card the two agree
    # within 0.05 ms); any other clock would be off by far more
    for e, s in zip(sorted(dispatch, key=lambda e: e['ts']), ours):
        assert abs(e['ts'] - s['ts']) < CPU_PROFILER_CLOCK_US
        assert abs(e['dur'] - s['dur']) < CPU_PROFILER_CLOCK_US
    s = profile_summary_torch.main([folder])
    assert s['spans']['train.dispatch'][0] == 2
    assert s['counters'] == record['counters']
    assert s['valid_share'] == pytest.approx(
        record['counters']['data.valid_parts'] / (2 * 2 * 5))
    assert record['max_num_part'] == 5
    assert s['valid_pair_share'] == pytest.approx(
        record['counters']['data.valid_pairs'] / (2 * 2 * 5 * 5))
    out = capsys.readouterr().out
    assert 'program span' in out and 'data.starved' in out
    assert 'valid share of the part pairs' in out


def test_profile_summary_regions_and_gaps():
    """Regions between the marks' kernels, nested, per step; the share of
    the busy time inside the outermost; the longest idle gaps named by the
    training thread's innermost span that covers most of them."""
    from profile_summary_torch import summarize

    def k(name, ts, dur):
        return {'ph': 'X', 'cat': 'kernel', 'name': name, 'ts': ts,
                'dur': dur}
    events = [k('mpa_mark_encoder_begin()', 0, 1),
              k('mpa_mark_masked_bn_begin', 2, 1), k('bn', 3, 4),
              k('mpa_mark_masked_bn_end', 7, 1),
              k('mpa_mark_encoder_end', 9, 1), k('other', 10, 10),
              k('mpa_mark_optimizer_begin', 20, 1), k('adam', 21, 2),
              k('mpa_mark_optimizer_end', 23, 1), k('late', 2030, 10)]
    spans = [{'name': 'train.flush', 'thread': 'MainThread', 'ts': 25,
              'dur': 2000},
             {'name': 'train.flush.write', 'thread': 'MainThread',
              'ts': 30, 'dur': 1990},
             {'name': 'data.collate', 'thread': 'loader-collate', 'ts': 0,
              'dur': 3000}]
    s = summarize(events, program_spans=spans, steps=2)
    assert s['regions'] == {'encoder': (8e-3 / 2, 1),
                            'masked_bn': (4e-3 / 2, 1),
                            'optimizer': (2e-3 / 2, 1)}
    # busy 2-8 and 9-23 between the first region's start and the last's
    # end, 2-8 and 21-23 inside the outermost regions
    assert s['region_cover'] == pytest.approx((6 + 2) / 20)
    gap_start, ms, under, label, others = s['gaps'][0]
    assert (gap_start, ms, label) == (24, 2.006, 'train.flush.write')
    assert others == {'loader-collate': 'data.collate'}
    assert under == pytest.approx(2000 / 2006)
    assert s['spans']['data.collate'] == (1, 3.0, 3.0)


def test_gpu_run_sh_parses():
    proc = subprocess.run(['bash', '-n', os.path.join(ROOT, 'scripts',
                                                      'gpu_run.sh')],
                          capture_output=True, text=True, timeout=30)
    assert proc.returncode == 0, proc.stderr
