"""The port's checkpoints, resume, weight loading, val export, loggers and
CLIs, on the CPU at a tiny width of the flagship config.

Held against the JAX trainer's semantics: the epochs kept are those orbax's
CheckpointManager keeps (max_to_keep=5, best by val/part_acc) on the same
metric sequence, run here side by side; a resumed trainer starts at the
next epoch with the saved step, its state bitwise the saved one, and its
next epoch gives bitwise the losses and weights of the uninterrupted run
given the same generator state; `test_torch.py --weight` gives bitwise the
test metrics of the trainer that saved the checkpoint."""

import glob
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from multi_part_assembly_tpu_torch.train import checkpoint as CK
from multi_part_assembly_tpu_torch.train.trainer import (JSONLLogger,
                                                         Trainer,
                                                         WandbLogger)
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'scripts'))
FLAGSHIP = os.path.join(ROOT, 'configs/pn_transformer/pn_transformer/'
                        'pn_transformer-32x1-cosine_400e-everyday.py')
TINY = ['model.pc_feat_dim', '16', 'model.transformer_feat_dim', '32',
        'model.transformer_heads', '4', 'model.transformer_layers', '2',
        'data.max_num_part', '6', 'data.num_pc_points', '32',
        'exp.batch_size', '2', 'exp.bf16', 'False']
EVAL_KEYS = {'val/part_acc', 'val/loss'} | {
    f'val/{k}_{m}' for k in ('trans', 'rot') for m in ('mse', 'rmse', 'mae')}


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    from make_synthetic_data import generate
    root = tmp_path_factory.mktemp('bb')
    os.environ['MPA_MESH_CACHE_DIR'] = str(root / 'mesh_cache')
    return generate(str(root / 'data'), n_shapes=6, min_parts=2,
                    max_parts=5, seed=0)


def _opts(synth, ckp_root, epochs=2):
    return ['data.data_dir', synth, 'exp.ckp_dir', str(ckp_root),
            'exp.num_epochs', str(epochs), 'exp.val_every', '1', *TINY]


def _cfg(opts):
    cfg = TCFG.load_cfg_file(FLAGSHIP).merge_from_list(opts)
    cfg.freeze()
    return cfg


def _state(trainer):
    """Every parameter, buffer and optimizer tensor, as (name, tensor)."""
    out = list(trainer.model.state_dict().items())
    opt = trainer.optimizer.state_dict()
    for pid, st in sorted(opt['state'].items()):
        out += [(f'opt.{pid}.{k}', v) for k, v in sorted(st.items())]
    return out


def _assert_bitwise(a, b):
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


def _epoch_losses(trainer, epoch):
    trainer.train_loader.set_epoch(epoch)
    return [trainer.train_step(b)['loss'] for b in trainer.train_loader]


@pytest.fixture(scope='module')
def trained(synth, tmp_path_factory):
    """A trainer fitted for 2 epochs, validating and saving after each."""
    run = tmp_path_factory.mktemp('run')
    opts = _opts(synth, run)
    trainer = Trainer(_cfg(opts), 'cpu', ckp_dir=str(run / 'ckp'),
                      quiet=True)
    trainer.fit()
    yield trainer, opts, str(run / 'ckp')
    trainer.close()


def test_fit_saves_checkpoints(trained):
    trainer, _, ckp = trained
    models = os.path.join(ckp, 'models')
    assert sorted(os.listdir(models)) == ['0', '1']
    for epoch in ('0', '1'):
        assert sorted(os.listdir(os.path.join(models, epoch))) == \
            [CK.METRICS_FILE, CK.STATE_FILE]
    with open(os.path.join(models, '1', CK.METRICS_FILE)) as f:
        saved = json.load(f)
    assert saved == trainer.metrics and EVAL_KEYS <= set(saved)
    assert all(np.isfinite(v) for v in saved.values())
    state = CK.load_state(os.path.join(models, '1'), 'cpu')
    assert state['epoch'] == 1 and state['step'] == trainer.step == 6


def test_val_vis_export(trained):
    """Every validation writes the GT and one prediction of each of its
    val_sample_vis (5) shapes, on a train and a val batch (batch 2 and 4),
    as the JAX trainer's export does (tests/test_trainer.py:164)."""
    _, _, ckp = trained
    plys = sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(ckp, 'vis', '*.ply')))
    for epoch in (0, 1):
        assert f'epoch{epoch}_train_shape1_gt.ply' in plys
        assert f'epoch{epoch}_train_shape1_pred0.ply' in plys
        assert f'epoch{epoch}_val_shape3_pred0.ply' in plys
    assert len(plys) == 2 * 2 * (2 + 4)
    with open(os.path.join(ckp, 'vis', 'epoch1_val_shape0_gt.ply')) as f:
        head = [next(f) for _ in range(3)]
    assert head[0] == 'ply\n' and head[2].startswith('element vertex ')


def test_resume_bitwise(trained):
    """A new trainer on the same ckp_dir resumes at epoch 2 with the saved
    step and every parameter, BN buffer and Adam moment bitwise; given the
    same generator and global RNG states, its next epoch gives bitwise the
    losses and weights of the first trainer's."""
    first, opts, ckp = trained
    second = Trainer(_cfg(opts), 'cpu', ckp_dir=ckp, quiet=True)
    try:
        assert second.start_epoch == 2 and second.step == first.step == 6
        _assert_bitwise(_state(second), _state(first))
        for st in second.optimizer.state.values():
            assert st['step'].device.type == 'cpu'
            assert st['step'].dtype == torch.float32
        gen, rng = first.generator.get_state(), torch.get_rng_state()
        losses = _epoch_losses(first, 2)
        second.generator.set_state(gen)
        torch.set_rng_state(rng)
        assert _epoch_losses(second, 2) == losses
        _assert_bitwise(_state(second), _state(first))
    finally:
        second.close()


def test_load_weights_step_dir_file_and_run_dir(trained):
    first, opts, ckp = trained
    step_dir = os.path.join(ckp, 'models', '0')
    os.utime(os.path.join(ckp, 'models', '1'))  # the newest by mtime
    assert CK.find_last_ckp(ckp).endswith(os.sep + '1')
    assert CK.find_last_ckp(os.path.join(ckp, 'nothing')) is None
    ref = CK.load_state(step_dir, 'cpu')
    for path in (step_dir, os.path.join(step_dir, CK.STATE_FILE)):
        other = Trainer(_cfg(opts), 'cpu', ckp_dir=ckp + '_load',
                        resume=False, quiet=True)
        other.load_weights(path)
        assert other.step == ref['step'] == 3
        for name, v in other.model.state_dict().items():
            assert torch.equal(v, ref['model'][name]), name
        other.close()


def test_test_cli_matches_the_trainer(trained, capsys):
    """scripts/test_torch.py on the CPU, --weight a step dir and a run
    dir, against the saving trainer's test() from the same generator
    state: the same test/* metrics, bit for bit."""
    import test_torch
    first, opts, ckp = trained
    state = first.generator.get_state()
    first.model.load_state_dict(
        CK.load_state(os.path.join(ckp, 'models', '1'), 'cpu')['model'])
    first.generator.manual_seed(first.cfg.exp.seed)
    ref = first.test()
    first.generator.set_state(state)
    for weight in (os.path.join(ckp, 'models', '1'), ckp):
        os.utime(os.path.join(ckp, 'models', '1'))
        got = test_torch.main(['--cfg_file', FLAGSHIP, '--device', 'cpu',
                               '--weight', weight, '--opts', *opts])
        assert got == ref
    out = capsys.readouterr().out
    assert 'test/part_acc:' in out and 'test/rot_rmse:' in out


def test_test_cli_category_all(tmp_path, capsys):
    """--category all: one trainer, its loaders swapped for each category,
    each tested from the checkpoint that `{}` names, and the LaTeX row of
    scripts/test.py (rot x1, trans x100, shape chamfer x1000, acc x100)
    over the categories' means."""
    import test_torch
    from make_synthetic_data import generate
    data = generate(str(tmp_path / 'data'), n_shapes=2, min_parts=2,
                    max_parts=4, seed=3, categories=['CatA', 'CatB'])
    opts = _opts(data, tmp_path, epochs=1) + ['data.all_category',
                                              'CatA,CatB']
    for cat in ('CatA', 'CatB'):
        cfg = TCFG.load_cfg_file(FLAGSHIP).merge_from_list(
            opts + ['data.category', cat])
        cfg.freeze()
        run = Trainer(cfg, 'cpu', ckp_dir=str(tmp_path / f'run-{cat}'),
                      quiet=True)
        run.fit()
        run.close()
    capsys.readouterr()
    results = test_torch.main([
        '--cfg_file', FLAGSHIP, '--device', 'cpu', '--category', 'all',
        '--weight', str(tmp_path / 'run-{}'), '--opts', *opts])
    out = capsys.readouterr().out
    assert out.count('test/part_acc:') == 3  # two categories, then the row
    assert len(results['test/part_acc']) == 2
    row = [ln for ln in out.splitlines() if ln.startswith('LaTeX row: ')]
    cells = row[0][len('LaTeX row: '):].rstrip(' \\').split(' & ')
    keys = test_torch.METRIC_ORDER
    expect = [f'{np.mean(results[k]) * test_torch.SCALE[k]:.2f}'
              for k in keys]
    assert cells == expect


def test_test_cli_refuses_missing_cuda(trained):
    import test_torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    _, opts, ckp = trained
    with pytest.raises(RuntimeError, match='no CUDA'):
        test_torch.main(['--cfg_file', FLAGSHIP, '--weight', ckp,
                         '--opts', *opts])


def test_swap_loaders_keeps_the_model(trained, synth):
    first, opts, _ = trained
    cfg = _cfg(opts + ['data.category', 'Synth'])
    weights = first.model.state_dict()['head.trans_head.weight'].clone()
    first.swap_loaders(cfg)
    assert first.cfg is cfg and len(first.val_loader.dataset) == 6
    assert torch.equal(first.model.state_dict()['head.trans_head.weight'],
                       weights)


# -- retention: the port's CheckpointManager against orbax's -------------

def _sequences():
    seqs = {
        'rising': [i / 10 for i in range(8)],
        'falling': [1 - i / 10 for i in range(8)],
        'ties': [0.5] * 8,
        'mixed': [0.1, 0.5, 0.5, 0.2, 0.5, 0.9, 0.1, 0.5, 0.3, 0.5],
        'no_metric': [None] * 7,
    }
    for seed in range(3):
        rng = np.random.default_rng(seed)
        seqs[f'random{seed}'] = [float(v) for v in
                                 rng.choice([0.0, 0.25, 0.5, 0.75, 1.0], 12)]
    return seqs


SEQUENCES = _sequences()


def _metrics(v):
    return {'val/loss': 1.0} if v is None else {'val/part_acc': v,
                                                'val/loss': 1.0}


@pytest.mark.parametrize('name', sorted(SEQUENCES))
def test_retention_matches_orbax(tmp_path, name):
    import orbax.checkpoint as ocp

    def orbax_manager():
        return ocp.CheckpointManager(
            str(tmp_path / 'orbax'), options=ocp.CheckpointManagerOptions(
                max_to_keep=5,
                best_fn=lambda m: m.get('val/part_acc', 0.0),
                best_mode='max', enable_async_checkpointing=False))

    ref = orbax_manager()
    ours = CK.CheckpointManager(str(tmp_path / 'port'))
    for epoch, v in enumerate(SEQUENCES[name]):
        ref.save(epoch, args=ocp.args.StandardSave({'x': np.zeros(2)}),
                 metrics=_metrics(v))
        ref.wait_until_finished()
        ours.save(epoch, {'x': torch.zeros(2)}, _metrics(v))
        assert ours.all_steps() == list(ref.all_steps()), epoch
        assert ours.latest_step() == ref.latest_step()
    ref.close()
    # a manager opened anew on the directory, as a resumed run's
    reopened = orbax_manager()
    again = CK.CheckpointManager(str(tmp_path / 'port'))
    assert again.latest_step() == reopened.latest_step()
    assert again.all_steps() == list(reopened.all_steps())
    reopened.close()


def test_cut_save_leaves_no_checkpoint(tmp_path):
    """A save killed before its rename leaves only its temporary
    directory, which no step lists and the next manager removes."""
    mgr = CK.CheckpointManager(str(tmp_path / 'models'))
    mgr.save(0, {'x': torch.ones(1)}, {'val/part_acc': 0.5})
    cut = tmp_path / 'models' / '.tmp-1'
    cut.mkdir()
    (cut / CK.STATE_FILE).write_bytes(b'half')
    assert mgr.latest_step() == 0 and mgr.all_steps() == [0]
    CK.CheckpointManager(str(tmp_path / 'models'))
    assert not cut.exists()
    with pytest.raises(FileExistsError):
        mgr.save(0, {'x': torch.ones(1)}, {})


# -- loggers ---------------------------------------------------------------

def test_jsonl_logger_quiet_and_echo(tmp_path, capsys):
    lg = JSONLLogger(str(tmp_path), quiet=False)
    lg.log({'a': 1.5, 'b': np.float32(2.5), 'c': torch.tensor(3.0)}, step=3,
           echo=['b', 'a'])
    lg.close()
    assert capsys.readouterr().out == 'b: 2.500000; a: 1.500000\n'
    with open(lg.path) as f:
        assert json.loads(f.read()) == {'a': 1.5, 'b': 2.5, 'c': 3.0,
                                        'step': 3}
    quiet = JSONLLogger(str(tmp_path), name='q', quiet=True)
    quiet.log({'a': 1.0}, echo=['a'])
    quiet.close()
    assert capsys.readouterr().out == ''


def test_wandb_logger_payloads(tmp_path, monkeypatch):
    """The wandb mirror with a stand-in module (the package is not
    installed): numeric scalars with int steps, and Object3D uploads of
    [P*N, 6] xyzrgb rows from torch tensors, as tests/test_trainer.py:298
    holds the JAX logger."""
    calls = {'log': [], 'finish': 0, 'init': []}

    class FakeRun:
        def log(self, payload, step=None):
            calls['log'].append((payload, step))

        def finish(self):
            calls['finish'] += 1

    class FakeObject3D:
        def __init__(self, arr):
            arr = np.asarray(arr)
            assert arr.ndim == 2 and arr.shape[1] == 6, arr.shape
            self.arr = arr

    fake = types.ModuleType('wandb')
    fake.init = lambda **kw: (calls['init'].append(kw), FakeRun())[1]
    fake.Object3D = FakeObject3D
    monkeypatch.setitem(sys.modules, 'wandb', fake)

    lg = WandbLogger(str(tmp_path), quiet=True, project='proj',
                     run_name='run')
    assert calls['init'][0]['project'] == 'proj'
    lg.log({'a': 1.5, 'b': torch.tensor(2.5), 'note': 'skip-me'},
           step=np.int64(7))
    payload, step = calls['log'][-1]
    assert payload == {'a': 1.5, 'b': 2.5} and step == 7
    B, P, N = 2, 3, 16
    gt = torch.randn(B, P, N, 3, generator=torch.Generator().manual_seed(0))
    valids = torch.tensor([[1., 1., 0.], [1., 1., 1.]])
    colors = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    lg.log_assemblies('val', gt, [gt + 0.1, gt + 0.2], valids, colors,
                      step=9, max_shapes=2)
    payload, step = calls['log'][-1]
    assert step == 9 and set(payload) == {
        f'val/{k}_{b}' for k in ('gt', 'pred0', 'pred1') for b in (0, 1)}
    assert payload['val/gt_0'].arr.shape == (2 * N, 6)
    assert payload['val/gt_1'].arr.shape == (3 * N, 6)
    assert np.allclose(payload['val/gt_1'].arr[:N, 3:], colors[0])
    lg.close()
    assert calls['finish'] == 1


def test_wandb_logger_without_wandb(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, 'wandb', None)  # import fails
    lg = WandbLogger(str(tmp_path))
    lg.log({'a': 1.0}, step=1)
    lg.log_assemblies('val', np.zeros((1, 1, 2, 3)), [], np.ones((1, 1)),
                      np.zeros((1, 3)))
    lg.close()
    assert 'logging to JSONL only' in capsys.readouterr().out


# -- the training CLI and the e2e check ---------------------------------------

def test_train_cli_weight_profile_and_seed(synth, tmp_path, monkeypatch):
    """--weight loads a checkpoint into a fresh run, --profile writes a
    trace, --vis 0 turns the export off and MPA_SEED sets the seed."""
    import train_torch
    base = ['--cfg_file', FLAGSHIP, '--device', 'cpu', '--opts',
            *_opts(synth, tmp_path, epochs=1)]
    first = train_torch.main(['--ckp_dir', str(tmp_path / 'a')] + base)
    weight = os.path.join(tmp_path, 'a', 'models', '0')
    monkeypatch.setenv('MPA_SEED', '7')
    second = train_torch.main(
        ['--ckp_dir', str(tmp_path / 'b'), '--weight', weight, '--vis', '0',
         '--profile', str(tmp_path / 'prof'), '--no_resume'] + base)
    assert second.cfg.exp.seed == 7 and second.cfg.exp.val_sample_vis == 0
    assert os.path.exists(tmp_path / 'prof' / 'trace.json')
    assert not os.path.exists(tmp_path / 'b' / 'vis')
    # loaded at step 3, then the profiled epoch and the run's epoch
    assert second.step == first.step + 6
    # a run on a ckp_dir with checkpoints resumes and trains no epoch more
    third = train_torch.main(['--ckp_dir', str(tmp_path / 'a')] + base)
    assert third.start_epoch == 1 and third.step == first.step


def test_e2e_check_cpu(tmp_path):
    """scripts/e2e_check_torch.py end to end on the CPU at a tiny size:
    train, checkpoints, resume, test, each a subprocess."""
    import e2e_check_torch
    result = e2e_check_torch.main([
        '--device', 'cpu', '--epochs', '2', '--threshold', '0',
        '--num_points', '32', '--workdir', str(tmp_path / 'e2e'),
        '--extra_opts', 'model.pc_feat_dim', '16',
        'model.transformer_feat_dim', '32', 'model.transformer_heads', '4',
        'model.transformer_layers', '1', 'exp.bf16', 'False'])
    assert result['ok'] and result['checkpoints'] == [0, 1]
    assert result['resume_line'].startswith('resumed from epoch 1')
    assert 0.0 <= result['test_part_acc'] <= 1.0


def test_misc_helpers_match_jax(tmp_path):
    """The port's copy of utils/misc.py writes the same files and gives
    the same arrays as the JAX package's, on the same inputs."""
    from multi_part_assembly_tpu.utils import misc as JM
    from multi_part_assembly_tpu_torch.utils import misc as TM
    rng = np.random.RandomState(0)
    parts = rng.randn(3, 5, 3).astype(np.float32)
    colors = rng.randint(0, 255, (4, 3))
    colored = TM.colorize_part_pc(parts, colors)
    np.testing.assert_array_equal(colored, JM.colorize_part_pc(parts, colors))
    np.testing.assert_array_equal(
        TM.colorize_part_pc(torch.tensor(parts), colors), colored)
    pmat = np.eye(4)
    pmat[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    pmat[:3, 3] = [1, 2, 3]
    np.testing.assert_allclose(TM.apply_pmat(parts[0], pmat),
                               JM.apply_pmat(parts[0], pmat))
    faces = np.asarray([[0, 1, 2], [2, 3, 4]])
    for name, args in (('save_pc', (colored.reshape(-1, 6), )),
                       ('save_pc', (parts.reshape(-1, 3), )),
                       ('save_obj', (parts[0], faces))):
        ours, ref = str(tmp_path / 'ours'), str(tmp_path / 'ref')
        getattr(TM, name)(*args, ours)
        getattr(JM, name)(*args, ref)
        assert open(ours).read() == open(ref).read(), name
    obj = {'a': parts, 'b': [1, 2]}
    TM.pickle_dump(obj, str(tmp_path / 'p.pkl'))
    back = JM.pickle_load(str(tmp_path / 'p.pkl'))
    np.testing.assert_array_equal(back['a'], parts)
    assert TM.pickle_load(open(tmp_path / 'p.pkl', 'rb'))['b'] == [1, 2]
    assert TM.pickle_dump(obj) == JM.pickle_dump(obj)
    np.testing.assert_array_equal(TM.to_numpy(torch.tensor(parts)), parts)
