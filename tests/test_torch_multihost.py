"""Two-rank data parallelism of the port's Trainer on the CPU: the port's
counterpart of tests/test_multihost.py.

Two gloo ranks (tests/torch_multihost_worker.py, spawned with torchrun's
variables) train the Global model on 8 shapes, 4 a rank: the host wire,
the device-sampling slot wire, and a partnet_chair-style semantic set with
Hungarian matching.  Checked: both ranks report the same all-reduced
validation metrics (within 1e-9, as JAX's test), a fresh two-rank Trainer
resumes at epoch 1 with its parameters bitwise those trained (the f64
checksum), the checkpoint was written once, by rank 0, and the metrics
log only by rank 0.
"""

import json
import os
import sys

import numpy as np
import pytest

from torch_ddp_worker import ROOT, spawn_ranks

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


def _geometry_set(root):
    rng = np.random.default_rng(0)
    lines = []
    for i in range(8):
        frac = root / 'Bottle' / f'obj{i}' / 'fractured_0'
        frac.mkdir(parents=True)
        for p in range(int(rng.integers(2, 4))):
            (frac / f'piece_{p}.obj').write_text(CUBE_OBJ)
        lines.append(f'Bottle/obj{i}')
    for split in ['train', 'val']:
        (root / f'everyday.{split}.txt').write_text('\n'.join(lines))
    return str(root)


def _partnet_set(root):
    sys.path.insert(0, os.path.join(ROOT, 'scripts'))
    from make_synthetic_data import generate_partnet
    return generate_partnet(str(root), n_shapes=8, min_parts=2, max_parts=4,
                            num_points=24, seed=0, split_prefix='Chair.')


def _run_two_ranks(tmp_path, mode):
    from multi_part_assembly_tpu_torch.datasets.mesh_io import MeshSampler
    MeshSampler()  # builds the native sampler once, before the ranks
    data = _partnet_set(tmp_path / 'partnet') if mode == 'semantic' else \
        _geometry_set(tmp_path / 'bb')
    ckp = tmp_path / 'ckp'
    worker = os.path.join(ROOT, 'tests', 'torch_multihost_worker.py')
    os.environ['MPA_MESH_CACHE_DIR'] = str(tmp_path / 'mesh_cache')
    logs = spawn_ranks(lambda r: [
        worker, '--data_dir', data, '--ckp_dir', str(ckp), '--out',
        str(tmp_path / f'out{r}.json'), '--mode', mode], timeout=300)
    m0, m1 = (json.load(open(tmp_path / f'out{r}.json')) for r in range(2))

    # the all-reduced eval: both ranks report identical values
    for scope in ('final', 'resumed'):
        assert m0[scope].keys() == m1[scope].keys()
        assert 'val/part_acc' in m0[scope]
        for k in m0[scope]:
            assert abs(m0[scope][k] - m1[scope][k]) < 1e-9, \
                (scope, k, m0[scope][k], m1[scope][k])
        assert all(np.isfinite(v) for v in m0[scope].values())
    # the resumed Trainer holds the trained parameters bit for bit, and
    # the ranks hold the same ones
    for m in (m0, m1):
        assert m['param_sum_resumed'] == m['param_sum_final']
        assert m['step'] == 1
    assert m0['param_sum_final'] == m1['param_sum_final']
    # one checkpoint, written by rank 0 alone; the metrics log by rank 0
    assert len(m0['writes']) == 1 and m1['writes'] == []
    assert sorted(os.listdir(ckp / 'models')) == ['0']
    with open(ckp / 'metrics.jsonl') as f:
        records = [json.loads(line) for line in f]
    assert sum('train/loss' in r for r in records) == 1
    assert sum('val/part_acc' in r for r in records) == 3
    # rank 0 said once a Trainer that the PLY export runs on one rank only
    assert logs[0].count('val PLY export skipped') == 2
    assert 'val PLY export skipped' not in logs[1]
    assert not (ckp / 'vis').exists()
    return m0


def test_two_rank_train(tmp_path):
    _run_two_ranks(tmp_path, 'packed')


def test_two_rank_train_slot_wire(tmp_path):
    """The device-sampling slot wire on each rank (its plain sampler on the
    CPU): the tables built per rank, the piece-slot wire sharded."""
    _run_two_ranks(tmp_path, 'slots')


def test_two_rank_semantic_epoch(tmp_path):
    """A partnet_chair-style Global epoch on two ranks: the resident part
    table on each, Hungarian matching (L1's plain version), part_acc and
    connectivity_acc all-reduced."""
    m0 = _run_two_ranks(tmp_path, 'semantic')
    assert 'val/connectivity_acc' in m0['final']
