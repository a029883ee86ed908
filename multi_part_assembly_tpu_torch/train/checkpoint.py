"""The trainer's checkpoints: one directory an epoch, the best kept.

The JAX trainer keeps its checkpoints with orbax's `CheckpointManager`
(`max_to_keep=5`, `best_fn=val/part_acc`, `best_mode='max'`;
multi_part_assembly_tpu/train/trainer.py:621-630).  This module keeps the
same set of epochs in plain files:

    <directory>/<epoch>/state.pt      model, optimizer, step and epoch
    <directory>/<epoch>/metrics.json  the validation metrics

A save is written into a temporary directory and renamed into place, so a
run killed during a save never leaves a half checkpoint behind.  After each
save the epochs are ranked by (metric, epoch), a missing metric counting
0.0, and all but the last MAX_TO_KEEP are deleted: on a tie the newer
epoch stays, and a new epoch worse than the kept ones is deleted at once,
as orbax does (tests/test_torch_checkpoint.py holds the two against each
other).

Under data parallelism rank 0 alone writes and prunes, and every rank
waits at a barrier after each save, so that a checkpoint is whole before
any rank reads it; every rank restores from the same directory onto its
own device.  The ranks rank the same metrics, which the eval all-reduces.
"""

import glob
import json
import os
import shutil

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


class CheckpointManager:
    """Saves and restores epochs under `directory`, keeping the
    MAX_TO_KEEP best by their BEST_KEY metric."""

    def __init__(self, directory):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # a save that was cut off left only its temporary directory
        if dist.rank() == 0:
            for stale in glob.glob(os.path.join(self.directory,
                                                _TMP_PREFIX + '*')):
                shutil.rmtree(stale)

    def _path(self, step):
        return os.path.join(self.directory, str(step))

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isdir(self._path(d)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step):
        path = os.path.join(self._path(step), METRICS_FILE)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def _rank(self, step):
        return (self.metrics(step).get(BEST_KEY, 0.0), step)

    def save(self, step, state, metrics):
        """Write `state` (anything torch.save takes) and `metrics` as
        epoch `step`, then drop the epochs past MAX_TO_KEEP: on rank 0,
        then a barrier for every rank."""
        if dist.rank() == 0:
            self._save(step, state, metrics)
        dist.barrier()

    def _save(self, step, state, metrics):
        final = self._path(step)
        if os.path.exists(final):
            raise FileExistsError(f'checkpoint {final} already exists')
        tmp = os.path.join(self.directory, f'{_TMP_PREFIX}{step}')
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METRICS_FILE), 'w') as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)
        os.rename(tmp, final)
        ranked = sorted(self.all_steps(), key=self._rank)
        for old in ranked[:max(0, len(ranked) - MAX_TO_KEEP)]:
            shutil.rmtree(self._path(old))

    def restore(self, step, map_location):
        return load_state(self._path(step), map_location)


def load_state(path, map_location):
    """The state saved in a checkpoint step directory, or in its
    state file."""
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    return torch.load(path, map_location=map_location, weights_only=True)
