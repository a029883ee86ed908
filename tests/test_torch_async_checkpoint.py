"""The port's asynchronous checkpoint save (train/checkpoint.py), the
counterpart of the JAX trainer's orbax manager with
`enable_async_checkpointing=True`, on the CPU at a tiny width of the
flagship config.

  - `save` returns while its write is held back, with nothing on disk yet;
    the file then holds the state of the save's moment bitwise, after
    further changes and further train steps;
  - the writer's error is raised by the next `wait_until_finished` (once),
    and a write cut before its rename leaves no checkpoint;
  - the next save waits for the one before; the retention rule holds under
    back-to-back saves;
  - a trainer that saves asynchronously and trains on resumes bitwise from
    the state it saved;
  - `fit` and `close` leave every save on disk.
"""

import os
import threading

import pytest
import torch
from test_torch_checkpoint import (_assert_bitwise, _cfg, _opts, _state,
                                   synth)  # noqa: F401 (fixture)

from multi_part_assembly_tpu_torch.train import checkpoint as CK
from multi_part_assembly_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)


class _Held:
    """Holds every `torch.save` of the checkpoint module until `release`;
    `fail` makes the held write raise after writing a partial file."""

    def __init__(self, monkeypatch, fail=None):
        self.entered = threading.Event()
        self.go = threading.Event()
        self.fail = fail
        real = CK.torch.save

        def save(obj, path):
            self.entered.set()
            assert self.go.wait(30), 'the test never released the writer'
            if self.fail is not None:
                with open(path, 'wb') as f:
                    f.write(b'half')
                raise self.fail
            real(obj, path)

        monkeypatch.setattr(CK.torch, 'save', save)

    def release(self):
        self.go.set()


def _on_disk(mgr):
    """The step directories as the file system has them now (the queries
    would wait for the writer)."""
    return sorted(int(d) for d in os.listdir(mgr.directory) if d.isdigit())


def test_save_returns_before_its_write(tmp_path, monkeypatch):
    held = _Held(monkeypatch)
    mgr = CK.CheckpointManager(str(tmp_path / 'models'))
    state = {'w': torch.arange(6.0), 'nested': [torch.ones(2), 3],
             'step': 4}
    mgr.save(0, state, {'val/part_acc': 0.5})
    assert held.entered.wait(10)
    assert _on_disk(mgr) == []
    # the caller goes on changing its state in place
    state['w'].mul_(-1)
    state['nested'][0].add_(1)
    held.release()
    mgr.wait_until_finished()
    assert _on_disk(mgr) == [0] and mgr.all_steps() == [0]
    saved = CK.load_state(str(tmp_path / 'models' / '0'), 'cpu')
    assert torch.equal(saved['w'], torch.arange(6.0))
    assert torch.equal(saved['nested'][0], torch.ones(2))
    assert saved['nested'][1] == 3 and saved['step'] == 4
    assert mgr.metrics(0) == {'val/part_acc': 0.5}
    assert len(mgr.write_seconds) == 1


def test_writer_error_is_raised_once(tmp_path, monkeypatch):
    held = _Held(monkeypatch, fail=OSError('disk full'))
    mgr = CK.CheckpointManager(str(tmp_path / 'models'))
    mgr.save(3, {'x': torch.ones(1)}, {})  # returns: the error comes later
    held.release()
    with pytest.raises(OSError, match='disk full'):
        mgr.wait_until_finished()
    mgr.wait_until_finished()  # raised once
    # the cut write left its temporary directory only, which no step lists
    # and the next manager removes
    assert mgr.all_steps() == []
    assert os.listdir(mgr.directory) == [f'{CK._TMP_PREFIX}3']
    CK.CheckpointManager(mgr.directory)
    assert os.listdir(mgr.directory) == []


def test_next_save_waits_for_the_one_before(tmp_path, monkeypatch):
    held = _Held(monkeypatch)
    mgr = CK.CheckpointManager(str(tmp_path / 'models'))
    mgr.save(0, {'x': torch.zeros(1)}, {'val/part_acc': 0.1})
    second = threading.Thread(target=mgr.save, args=(
        1, {'x': torch.ones(1)}, {'val/part_acc': 0.2}))
    second.start()
    second.join(0.3)
    assert second.is_alive()  # blocked behind the held first write
    held.release()
    second.join(10)
    assert not second.is_alive()
    mgr.wait_until_finished()
    assert mgr.all_steps() == [0, 1]


def test_back_to_back_saves_keep_the_best(tmp_path):
    """Saves with no query between them keep what the synchronous rule
    kept: the five best by val/part_acc, the newer on a tie."""
    mgr = CK.CheckpointManager(str(tmp_path / 'models'))
    accs = [0.3, 0.9, 0.1, 0.9, 0.5, 0.2, 0.7, 0.0]
    for epoch, acc in enumerate(accs):
        mgr.save(epoch, {'x': torch.full((2, ), float(epoch))},
                 {'val/part_acc': acc})
    mgr.wait_until_finished()
    assert mgr.all_steps() == [0, 1, 3, 4, 6]
    assert mgr.latest_step() == 6


def _trainer(synth_dir, ckp, resume):
    return Trainer(_cfg(_opts(synth_dir, ckp, epochs=3)), 'cpu',
                   ckp_dir=str(ckp), resume=resume, quiet=True)


def test_trainer_saves_the_state_of_its_moment(synth, tmp_path,  # noqa: F811
                                               monkeypatch):
    """A trainer saves (held), then trains another epoch: the checkpoint
    holds the state at the save, which differs from the state after; a new
    trainer resumes bitwise from it."""
    held = _Held(monkeypatch)
    first = _trainer(synth, tmp_path / 'ckp', resume=False)
    first.train_epoch(0)
    at_save = [(n, v.clone()) for n, v in _state(first)]
    step = first.step
    first.save_checkpoint(0, {'val/part_acc': 0.5})
    assert held.entered.wait(10)
    first.train_epoch(1)
    after = _state(first)
    assert any(not torch.equal(x, y) for (_, x), (_, y) in zip(at_save,
                                                                 after))
    held.release()
    first.ckpt_mgr.wait_until_finished()
    assert first.ckpt_mgr.all_steps() == [0]
    second = _trainer(synth, tmp_path / 'ckp', resume=True)
    assert second.start_epoch == 1 and second.step == step
    _assert_bitwise(_state(second), at_save)
    first.close()
    second.close()


def test_fit_and_close_leave_the_saves_on_disk(synth,  # noqa: F811
                                              tmp_path):
    trainer = _trainer(synth, tmp_path / 'ckp', resume=False)
    trainer.fit()
    assert not trainer.ckpt_mgr._pending
    assert sorted(os.listdir(trainer.ckpt_mgr.directory)) == ['0', '1', '2']
    trainer.save_checkpoint(3, {'val/part_acc': 1.0})
    trainer.close()
    assert sorted(os.listdir(trainer.ckpt_mgr.directory)) == \
        ['0', '1', '2', '3']
    assert len(trainer.ckpt_mgr.write_seconds) == 4
    # load_weights waits for a pending save of its own trainer
    trainer.save_checkpoint(4, {'val/part_acc': 0.0})
    trainer.load_weights(os.path.join(trainer.ckpt_mgr.directory, '4'))
