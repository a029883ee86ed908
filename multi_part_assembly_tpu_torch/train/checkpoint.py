"""The trainer's checkpoints: one directory an epoch, the best kept.

The JAX trainer keeps its checkpoints with orbax's `CheckpointManager`
(`max_to_keep=5`, `best_fn=val/part_acc`, `best_mode='max'`;
multi_part_assembly_tpu/train/trainer.py:621-630).  This module keeps the
same set of epochs in plain files:

    <directory>/<epoch>/state.pt      model, optimizer, step and epoch
    <directory>/<epoch>/metrics.json  the validation metrics

A save is asynchronous, as orbax's with `enable_async_checkpointing=True`
(JAX trainer.py:621-630, 654-658): `save` snapshots the state into host
memory on the caller's thread (a CUDA tensor by a non-blocking copy into
one pinned buffer of the manager's, reused by later saves, on a stream of
its own, which the caller's stream then waits for, so that the next
step's in-place updates come after it) and returns; one writer thread
waits for the copies, writes the checkpoint into a temporary directory
and renames it into place, so a run killed during a write never leaves a
half checkpoint behind.  After each
write the epochs are ranked by (metric, epoch), a missing metric counting
0.0, and all but the last MAX_TO_KEEP are deleted: on a tie the newer
epoch stays, and a new epoch worse than the kept ones is deleted at once,
as orbax does (tests/test_torch_checkpoint.py holds the two against each
other).  A checkpoint is on disk once `wait_until_finished` returns, which
the next save, the trainer's resume and weight loading, the end of its
`fit` and its `close` call; it re-raises the writer's error.  The queries
(`all_steps`, `latest_step`, `metrics`, `restore`) wait for this
process's writer first.

Under data parallelism rank 0 alone snapshots, writes and prunes, and
`wait_until_finished` ends in a barrier of every rank, so that a
checkpoint is whole before any rank reads it; every rank restores from the
same directory onto its own device.  The ranks rank the same metrics,
which the eval all-reduces.
"""

import glob
import json
import os
import shutil
import threading
import time

import torch

from ..parallel import dist

__all__ = ['CheckpointManager', 'find_last_ckp', 'load_state', 'STATE_FILE',
           'METRICS_FILE']

STATE_FILE = 'state.pt'
METRICS_FILE = 'metrics.json'
_TMP_PREFIX = '.tmp-'
MAX_TO_KEEP = 5
BEST_KEY = 'val/part_acc'  # higher is better


def find_last_ckp(ckp_dir):
    """The newest checkpoint step directory under `ckp_dir/models` by
    mtime, or None (the port's copy of scripts/collect_test.py:22-29)."""
    cands = glob.glob(os.path.join(ckp_dir, 'models', '*'))
    cands = [c for c in cands if os.path.isdir(c) and
             os.path.basename(c).isdigit()]
    if not cands:
        return None
    return max(cands, key=os.path.getmtime)


_ALIGN = 64  # bytes: each tensor's place in the pinned buffer


def _tensors(tree):
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def _map(tree, fn):
    """`tree` with each tensor t replaced by fn(t)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def _place(nbytes):
    return -(-nbytes // _ALIGN) * _ALIGN


class CheckpointManager:
    """Saves and restores epochs under `directory`, keeping the
    MAX_TO_KEEP best by their BEST_KEY metric; saves are asynchronous.

    `write_seconds` holds the writer's wall time of each write (waiting
    for the copies included)."""

    def __init__(self, directory):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # a save that was cut off left only its temporary directory
        if dist.rank() == 0:
            for stale in glob.glob(os.path.join(self.directory,
                                                _TMP_PREFIX + '*')):
                shutil.rmtree(stale)
        self._writer = None  # this process's writer thread
        self._error = None  # the writer's exception, raised once
        self._pending = False  # a save every rank has yet to wait for
        self._stream = None
        self._host = None  # pinned bytes the snapshots of CUDA tensors use
        self.write_seconds = []

    def _path(self, step):
        return os.path.join(self.directory, str(step))

    def _steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isdir(self._path(d)))

    def _join_writer(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def all_steps(self):
        self._join_writer()
        return self._steps()

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step):
        self._join_writer()
        return self._read_metrics(step)

    def _read_metrics(self, step):
        path = os.path.join(self._path(step), METRICS_FILE)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def _rank(self, step):
        return (self._read_metrics(step).get(BEST_KEY, 0.0), step)

    def save(self, step, state, metrics):
        """Start saving `state` (nested dicts, lists and tuples of tensors
        and plain values) and `metrics` as epoch `step`, and return: the
        state is snapshotted now, written by the writer thread.  Waits for
        the previous save first."""
        self.wait_until_finished()
        self._pending = True
        if dist.rank() != 0:
            return
        if os.path.exists(self._path(step)):
            raise FileExistsError(f'checkpoint {self._path(step)} already '
                                  'exists')
        cuda = [t for t in _tensors(state) if t.device.type == 'cuda']
        ready = None
        if cuda:
            state = self._snapshot_cuda(state, cuda)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        else:
            state = _map(state, lambda t: t.detach().clone())
        metrics = {k: float(v) for k, v in metrics.items()}
        self._writer = threading.Thread(
            target=self._write, args=(step, state, metrics, ready),
            name='checkpoint-writer')
        self._writer.start()

    def _snapshot_cuda(self, state, cuda):
        """`state` with its CUDA tensors' copies issued into views of one
        pinned buffer, kept for later saves: on the manager's stream, after
        the caller's stream, which then waits for the copies, so that no
        later in-place update overtakes them."""
        total = sum(_place(t.numel() * t.element_size()) for t in cuda)
        if self._host is None or self._host.numel() < total:
            self._host = torch.empty(total, dtype=torch.uint8,
                                     pin_memory=True)
            self._stream = torch.cuda.Stream(cuda[0].device)
        current = torch.cuda.current_stream(cuda[0].device)
        self._stream.wait_stream(current)
        offset = [0]

        def copy(t):
            if t.device.type != 'cuda':
                return t.detach().clone()
            n = t.numel() * t.element_size()
            view = self._host[offset[0]:offset[0] + n].view(
                t.dtype).reshape(t.shape)
            offset[0] += _place(n)
            return view.copy_(t.detach(), non_blocking=True)

        with torch.cuda.stream(self._stream):
            state = _map(state, copy)
        current.wait_stream(self._stream)
        return state

    def _write(self, step, state, metrics, ready):
        t0 = time.perf_counter()
        try:
            if ready is not None:
                ready.synchronize()
                # tensors of their own in the file; the buffer is reused
                host = self._host.untyped_storage().data_ptr()
                state = _map(state, lambda t: t.clone() if
                             t.untyped_storage().data_ptr() == host else t)
            self._save(step, state, metrics)
        except Exception as e:  # raised by wait_until_finished
            self._error = e
        self.write_seconds.append(time.perf_counter() - t0)

    def wait_until_finished(self):
        """Block until the pending save is on disk, then a barrier of every
        rank; re-raises the writer's error."""
        if not self._pending:
            return
        self._join_writer()
        self._pending = False
        dist.barrier()
        error, self._error = self._error, None
        if error is not None:
            raise error

    def _save(self, step, state, metrics):
        final = self._path(step)
        if os.path.exists(final):
            raise FileExistsError(f'checkpoint {final} already exists')
        tmp = os.path.join(self.directory, f'{_TMP_PREFIX}{step}')
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METRICS_FILE), 'w') as f:
            json.dump(metrics, f)
        os.rename(tmp, final)
        ranked = sorted(self._steps(), key=self._rank)
        for old in ranked[:max(0, len(ranked) - MAX_TO_KEEP)]:
            shutil.rmtree(self._path(old))

    def restore(self, step, map_location):
        self._join_writer()
        return load_state(self._path(step), map_location)


def load_state(path, map_location):
    """The state saved in a checkpoint step directory, or in its
    state file."""
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    return torch.load(path, map_location=map_location, weights_only=True)
