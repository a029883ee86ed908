"""Every family's `*-partnet_chair.py` config through the port's CLIs on
the CPU: scripts/train_torch.py (train, validate with part_acc and
connectivity_acc, checkpoint, resume), scripts/test_torch.py from a
checkpoint against the trainer's own test(), and the semantic rows of
scripts/e2e_check_torch.py at a tiny size.  Equal means bit for bit: the
same code runs on the same device from the same seeds.
"""

import os
import sys

import numpy as np
import pytest
import torch

import torch_family_parity as U

torch.set_num_threads(2)

sys.path.insert(0, os.path.join(U.ROOT, 'scripts'))
CONFIGS = U.SEMANTIC_CONFIGS
FAMILIES = sorted(CONFIGS)
NARROW = U.NARROW


@pytest.fixture(scope='module')
def partnet(tmp_path_factory):
    from make_synthetic_data import generate_partnet
    root = str(tmp_path_factory.mktemp('partnet'))
    return generate_partnet(root, n_shapes=6, min_parts=2, max_parts=4,
                            num_points=32, seed=0, split_prefix='Chair.')


@pytest.mark.parametrize('family', FAMILIES)
def test_partnet_config_trains_tests_and_resumes_on_cpu(family, partnet,
                                                        tmp_path):
    """scripts/train_torch.py on the family's partnet_chair config at a tiny
    size, on the CPU: two epochs of three steps on the slot wire, a
    validation with part_acc and connectivity_acc and a checkpoint each;
    scripts/test_torch.py from the newest checkpoint gives the trainer's
    own test metrics; the run resumes on its ckp_dir."""
    import test_torch
    import train_torch
    opts = ['data.data_dir', partnet, 'exp.ckp_dir', str(tmp_path / 'cli'),
            'exp.num_epochs', '2', 'exp.val_every', '1', 'exp.batch_size',
            '2', 'data.max_num_part', '4', 'data.num_pc_points', '32',
            'exp.bf16', 'False', 'data.device_table', 'True',
            'loss.sample_iter', '2', *NARROW[family]]
    if family == 'pn_transformer_refine':  # pos_enc (128, 128) sets 128
        i = opts.index('model.pc_feat_dim')
        del opts[i:i + 2]
    cfg_file = os.path.join(U.ROOT, CONFIGS[family])
    args = ['--cfg_file', cfg_file, '--device', 'cpu', '--ckp_dir',
            str(tmp_path / 'run'), '--vis', '1', '--opts', *opts]
    first = train_torch.main(args)
    assert first.step == 6 and first.ckpt_mgr.all_steps() == [0, 1]
    assert first.part_tables['train'] is not None
    keys = {'val/part_acc', 'val/connectivity_acc', 'val/loss',
            'val/transform_pt_cd_loss'}
    assert keys <= set(first.metrics)
    assert not any(k.startswith(('val/trans_m', 'val/rot_m'))
                   for k in first.metrics)
    assert all(np.isfinite(v) for v in first.metrics.values())
    first.generator.manual_seed(first.cfg.exp.seed)
    ref = first.test()
    got = test_torch.main(['--cfg_file', cfg_file, '--device', 'cpu',
                           '--weight', str(tmp_path / 'run' / 'models' / '1'),
                           '--opts', *opts])
    assert got == ref
    with pytest.raises(ValueError, match='geometric'):
        test_torch.main(['--cfg_file', cfg_file, '--device', 'cpu',
                         '--category', 'all', '--opts', *opts])
    again = train_torch.main(args[:-len(opts)] + opts[:5] + ['3'] +
                             opts[6:])
    assert again.start_epoch == 2 and again.step == 9


@pytest.mark.parametrize('row', ['pn_transformer_partnet_mon',
                                 'identity_partnet'])
def test_e2e_check_semantic_rows_cpu(row, tmp_path):
    """scripts/e2e_check_torch.py's semantic rows on the CPU at a tiny
    size: a synthetic PartNet tree; the _mon row keeps sample_iter 5 and
    trains, saves, resumes and tests, each a subprocess; identity's row
    runs test_torch.py alone."""
    import e2e_check_torch
    spec = e2e_check_torch.FAMILIES[row]
    assert spec['task'] == 'semantic'
    result = e2e_check_torch.main([
        '--model', row, '--device', 'cpu', '--epochs', '2', '--threshold',
        '0', '--num_points', '32', '--workdir', str(tmp_path / 'e2e'),
        '--extra_opts', 'model.pc_feat_dim', '16',
        'model.transformer_feat_dim', '32', 'model.transformer_heads', '4',
        'model.transformer_layers', '1', 'exp.bf16', 'False'])
    assert result['ok']
    assert 0.0 <= result['test_part_acc'] <= 1.0
    if row.endswith('_mon'):
        assert spec['mon'] and result['checkpoints'] == [0, 1]
        assert result['resume_line'].startswith('resumed from epoch 1')
