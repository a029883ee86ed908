"""The port's step dispatch on the CPU: `exp.steps_per_call` groups,
buffered logs, the stacked eval sums and the lr of each step.

Held against the JAX trainer's semantics (train/trainer.py:518-526,
686-854; parallel/mesh.py:232 `make_train_step_multi`): a group of G steps
is G single steps, so grouped and ungrouped epochs give bitwise the same
weights, optimizer state and log rows, one row a step with consecutive
step numbers, the numbering JAX's own grouped trainer gives on the same
setup.  The stacked eval adds each key's f32 batch sum in f64 as the
per-key loop did: the metrics agree within 1e-12 (they are equal).  The
CUDA graph itself needs a card: tests/test_torch_cuda.py holds its replays
against eager steps.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from multi_part_assembly_tpu_torch.train import schedules as TS
from multi_part_assembly_tpu_torch.train import step as TSTEP
from multi_part_assembly_tpu_torch.train.core import mon_loss
from multi_part_assembly_tpu_torch.train.state import set_lr
from multi_part_assembly_tpu_torch.train.trainer import Trainer
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
CUBE_OBJ = """v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
v 1 0 1
v 1 1 1
v 0 1 1
f 1 2 3 4
f 5 8 7 6
f 1 5 6 2
f 2 6 7 3
f 3 7 8 4
f 5 1 4 8
"""


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    """10 shapes: 5 train steps of batch 2 an epoch."""
    from make_synthetic_data import generate
    root = tmp_path_factory.mktemp('bb')
    os.environ['MPA_MESH_CACHE_DIR'] = str(root / 'mesh_cache')
    return generate(str(root / 'data'), n_shapes=10, min_parts=2,
                    max_parts=5, seed=0)


def _cfg(synth, ckp, *opts):
    cfg = TCFG.load_cfg_file(FLAGSHIP).merge_from_list(
        ['data.data_dir', synth, 'exp.ckp_dir', str(ckp), 'exp.num_epochs',
         '2', 'exp.val_every', '1', 'exp.val_sample_vis', '0', *TINY,
         *opts])
    cfg.freeze()
    return cfg


def _state(trainer):
    out = list(trainer.model.state_dict().items())
    opt = trainer.optimizer.state_dict()
    for pid, st in sorted(opt['state'].items()):
        out += [(f'opt.{pid}.{k}', v) for k, v in sorted(st.items())]
    return out


def _rows(ckp):
    """The JSONL's train rows, without the host's data wait."""
    with open(os.path.join(ckp, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k != 'train/data_time'}
            for r in rows if 'train/loss' in r]


def _train(synth, ckp, spc, epochs=2):
    trainer = Trainer(_cfg(synth, ckp, 'exp.steps_per_call', str(spc)),
                      'cpu', ckp_dir=str(ckp), quiet=True)
    assert trainer.steps_per_call == spc and trainer.compiled is None
    for epoch in range(epochs):
        trainer.train_epoch(epoch)
    trainer.close()
    return trainer


@pytest.fixture(scope='module')
def ungrouped(synth, tmp_path_factory):
    ckp = tmp_path_factory.mktemp('spc1')
    trainer = _train(synth, ckp, 1)
    return _state(trainer), _rows(ckp), trainer


@pytest.mark.parametrize('spc', [2, 3])
def test_grouped_epochs_equal_single_steps(synth, tmp_path, ungrouped, spc):
    """5 steps an epoch in groups of 2 (a tail of 1) or 3 (a tail of 2):
    weights, Adam state, BN statistics and log rows bitwise those of
    steps_per_call 1."""
    ref_state, ref_rows, ref = ungrouped
    trainer = _train(synth, tmp_path, spc)
    assert trainer.step == ref.step == 10
    state = _state(trainer)
    assert [n for n, _ in state] == [n for n, _ in ref_state]
    for (name, a), (_, b) in zip(state, ref_state):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert _rows(tmp_path) == ref_rows
    assert [r['step'] for r in ref_rows] == list(range(1, 11))
    assert len(trainer.step_seconds) == 10


def _cube_set(root):
    """tests/test_trainer.py's fixture data: 6 shapes of 2-3 cube parts."""
    lines = []
    rng = np.random.default_rng(0)
    for i in range(6):
        frac = root / 'Bottle' / f'obj{i}' / 'fractured_0'
        frac.mkdir(parents=True)
        for p in range(int(rng.integers(2, 4))):
            (frac / f'piece_{p}.obj').write_text(CUBE_OBJ)
        lines.append(f'Bottle/obj{i}')
    for split in ['train', 'val']:
        (root / f'everyday.{split}.txt').write_text('\n'.join(lines))
    return str(root)


def _grouped_cfg(CN, data_dir, ckp):
    """tests/test_trainer.py's `cfg` fixture with batch 3 and
    steps_per_call 2 (test_trainer_grouped_steps)."""
    cfg = CN()
    cfg.exp = CN({'batch_size': 3, 'num_epochs': 2, 'val_every': 1,
                  'num_workers': 2, 'ckp_dir': ckp, 'seed': 0,
                  'val_sample_vis': 0, 'weight_file': '',
                  'steps_per_call': 2})
    cfg.data = CN({
        'dataset': 'geometry', 'data_dir': data_dir,
        'data_fn': 'everyday.{}.txt', 'data_keys': ('part_ids', ),
        'category': '', 'rot_range': -1., 'num_pc_points': 24,
        'min_num_part': 2, 'max_num_part': 4, 'shuffle_parts': False,
        'overfit': -1,
    })
    cfg.optimizer = CN({'lr': 1e-3, 'weight_decay': 0., 'warmup_ratio': 0.,
                        'clip_grad': None, 'lr_scheduler': 'cosine',
                        'lr_decay_factor': 100.})
    cfg.model = CN({'name': 'global', 'rot_type': 'quat', 'pc_feat_dim': 16,
                    'encoder': 'pointnet'})
    cfg.loss = CN({'noise_dim': 4, 'sample_iter': 2, 'trans_loss_w': 1.,
                   'rot_pt_cd_loss_w': 10., 'transform_pt_cd_loss_w': 10.,
                   'use_rot_loss': True, 'rot_loss_w': 0.2,
                   'use_rot_pt_l2_loss': True, 'rot_pt_l2_loss_w': 1.})
    return cfg


def _train_steps(ckp):
    with open(os.path.join(ckp, 'metrics.jsonl')) as f:
        return [r['step'] for r in map(json.loads, f) if 'train/loss' in r]


def test_grouped_step_numbers_match_jax(tmp_path, monkeypatch):
    """JAX tests/test_trainer.py:91's setup (6 shapes, batch 3,
    steps_per_call 2, 2 epochs) through the JAX Trainer and the port's:
    one train row a step, steps [1, 2, 3, 4] in both."""
    import jax

    from multi_part_assembly_tpu.train.trainer import Trainer as JTrainer
    from multi_part_assembly_tpu.utils import CN as JCN
    data = _cube_set(tmp_path / 'breaking_bad')
    monkeypatch.setattr(jax, 'local_device_count', lambda: 1)
    jckp = str(tmp_path / 'jax')
    jax_trainer = JTrainer(_grouped_cfg(JCN, data, jckp), ckp_dir=jckp,
                           quiet=True)
    assert jax_trainer.steps_per_call == 2
    jax_trainer.fit()
    jax_trainer.close()
    monkeypatch.undo()

    ckp = str(tmp_path / 'torch')
    trainer = Trainer(_grouped_cfg(TCFG.CN, data, ckp), 'cpu', ckp_dir=ckp,
                      quiet=True)
    assert trainer.steps_per_call == 2
    trainer.fit()
    trainer.close()
    assert trainer.step == 4
    assert _train_steps(ckp) == _train_steps(jckp) == [1, 2, 3, 4]


def _loader(slots):
    ds = types.SimpleNamespace(_device_tables=object() if slots else None)
    return types.SimpleNamespace(dataset=ds)


@pytest.mark.parametrize('spc,slots,device,want', [
    (0, True, 'cpu', 1), (0, False, 'cpu', 1), (0, True, 'cuda', 8),
    (0, False, 'cuda', 1), (None, True, 'cuda', 8), (3, True, 'cuda', 3),
    (2, False, 'cpu', 2)])
def test_auto_rule(spc, slots, device, want):
    """0 or absent: 8 on a slot wire on the card, else 1; a positive value
    wins (JAX trainer.py:518-526).  A function of the loader and the
    device: no card needed."""
    cfg = TCFG.CN({'exp': TCFG.CN({} if spc is None
                                  else {'steps_per_call': spc})})
    assert TSTEP.steps_per_call(cfg, _loader(slots), device) == want


def test_auto_rule_reads_the_part_table():
    ds = types.SimpleNamespace(_device_ptable=object())
    loader = types.SimpleNamespace(dataset=ds)
    assert TSTEP.slot_wire(loader)
    cfg = TCFG.CN({'exp': TCFG.CN({'steps_per_call': 0})})
    assert TSTEP.steps_per_call(cfg, loader, torch.device('cuda')) == 8


@pytest.mark.parametrize('spc,flushes', [(1, [4, 1]), (3, [3, 2])])
def test_flush_cadence(synth, tmp_path, spc, flushes):
    """The logs are fetched once `LOG_FLUSH_STEPS` steps are buffered (after
    a group) and at the end of the epoch; every step gets its row, in step
    order."""
    assert Trainer.LOG_FLUSH_STEPS == 32
    trainer = Trainer(_cfg(synth, tmp_path, 'exp.steps_per_call', str(spc)),
                      'cpu', ckp_dir=str(tmp_path), quiet=True)
    trainer.LOG_FLUSH_STEPS = 3 if spc == 3 else 4
    sizes = []
    flush = trainer._flush_train_logs

    def counted():
        n = trainer._buffered_steps()
        if n:
            sizes.append(n)
        return flush()

    trainer._flush_train_logs = counted
    logs = trainer.train_epoch(0)
    trainer.close()
    assert sizes == flushes
    assert [r['step'] for r in _rows(tmp_path)] == [1, 2, 3, 4, 5]
    assert logs['loss'] == _rows(tmp_path)[-1]['train/loss']


def test_stacked_eval_matches_per_key_sums(synth, tmp_path):
    """The device-side f64 sums fetched once equal the per-key loop that
    fetched every key's f32 batch sum (within 1e-12; they are equal)."""
    trainer = Trainer(_cfg(synth, tmp_path), 'cpu', ckp_dir=str(tmp_path),
                      quiet=True)
    trainer.train_epoch(0)
    state = trainer.generator.get_state()
    trainer.model.eval()
    sums, weight = {}, 0
    with torch.no_grad():
        for batch in trainer.val_loader:
            data = trainer._augment(batch)
            _, logs = mon_loss(trainer.model, data, cfg=trainer.cfg,
                               training=False, reduce=False,
                               generator=trainer.generator)
            for k, v in logs.items():
                sums[k] = sums.get(k, 0.0) + float(v.sum())
            weight += data['part_valids'].shape[0]
    ref = {f'val/{k}': v / weight for k, v in sums.items()}
    trainer.generator.set_state(state)
    got = trainer._eval_loop(trainer.val_loader, 'val')
    trainer.close()
    assert set(got) == set(ref) and len(ref) >= 9
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-12 * max(1.0, abs(v)), k


@pytest.mark.parametrize('kind', ['cosine', 'linear'])
def test_lr_of_every_step_is_the_schedule(synth, tmp_path, kind):
    """Each step's lr equals train/schedules.py at its index: in the JSONL
    (the schedule's value) and in a device-style lr scalar filled by
    `set_lr` (the value rounded to f32), across the warmup, the decay and
    the epoch boundaries of a cosine and a linear schedule."""
    epochs, spe = 6, 5
    cfg = TCFG.CN({
        'exp': TCFG.CN({'num_epochs': epochs}),
        'optimizer': TCFG.CN({'lr': 1e-3, 'lr_scheduler': kind,
                              'warmup_ratio': 0.34,
                              'lr_decay_factor': 100.0})})
    sched = TS.build_lr_schedule(cfg, spe)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.Adam([p], lr=torch.tensor(0.0), foreach=False)
    values = []
    for step in range(epochs * spe):
        set_lr(opt, sched(step))
        lr = opt.param_groups[0]['lr']
        assert lr.dtype == torch.float32
        assert lr.item() == np.float32(sched(step)), step
        values.append(sched(step))
    # one value an epoch, warmup and decay both reached
    assert all(len(set(values[e * spe:(e + 1) * spe])) == 1
               for e in range(epochs))
    assert len(set(values)) >= 4

    trainer = Trainer(_cfg(synth, tmp_path, 'optimizer.lr_scheduler', kind,
                           'exp.steps_per_call', '2'),
                      'cpu', ckp_dir=str(tmp_path), quiet=True)
    for epoch in range(2):
        trainer.train_epoch(epoch)
    trainer.close()
    rows = _rows(tmp_path)
    assert [r['train/lr'] for r in rows] == \
        [trainer.lr_schedule(r['step'] - 1) for r in rows]


def test_checkpoint_lr_is_a_float(synth, tmp_path):
    """A saved optimizer's groups carry the lr as a number, whatever holds
    it in the trainer, so a checkpoint loads on either device."""
    trainer = Trainer(_cfg(synth, tmp_path), 'cpu', ckp_dir=str(tmp_path),
                      quiet=True)
    trainer.train_epoch(0)
    trainer.optimizer.param_groups[0]['lr'] = torch.tensor(5e-4)
    trainer.save_checkpoint(0, {'val/part_acc': 0.5})
    trainer.close()
    state = torch.load(os.path.join(tmp_path, 'models', '0', 'state.pt'),
                       weights_only=False)
    lrs = [g['lr'] for g in state['optimizer']['param_groups']]
    assert all(type(v) is float for v in lrs) and lrs[0] == \
        pytest.approx(5e-4)
    assert torch.is_tensor(trainer.optimizer.param_groups[0]['lr'])


def test_uncapturable_rule_names_its_op():
    cfg = TCFG.load_cfg_file(FLAGSHIP)
    assert TSTEP.uncapturable(cfg) is None
    for (key, value), reason in TSTEP._UNCAPTURABLE.items():
        section, name = key.split('.')
        other = cfg.clone()
        other[section][name] = value
        assert reason in TSTEP.uncapturable(other)
