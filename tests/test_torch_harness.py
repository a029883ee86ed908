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


def test_gpu_run_sh_parses():
    proc = subprocess.run(['bash', '-n', os.path.join(ROOT, 'scripts',
                                                      'gpu_run.sh')],
                          capture_output=True, text=True, timeout=30)
    assert proc.returncode == 0, proc.stderr
