"""The port's PartNet data (datasets/partnet.py, datasets/part_table.py) and
its trainer wiring against the JAX package's.

On a synthetic PartNet-format tree (scripts/make_synthetic_data.py
`generate_partnet`, with a `part_label` class per part) both packages
build their datasets; items, the host wire's batches (packed f16 rows and
pack_index) and the slot wire's (part slots, then the clouds gathered from
the resident table) must be equal bit for bit, with and without the part
shuffle (the same numpy seed on both sides).  The trainer reads
`data.device_table` as it reads `data.device_sampling`, and trains the
same first step on both wires.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_part_assembly_tpu.datasets import part_table as JPT
from multi_part_assembly_tpu.datasets.geometry import \
    unpack_parts as jax_unpack
from multi_part_assembly_tpu.datasets.partnet import \
    PartNetPartDataset as JaxDataset
from multi_part_assembly_tpu_torch.datasets import build_dataloader
from multi_part_assembly_tpu_torch.datasets import part_table as TPT
from multi_part_assembly_tpu_torch.datasets.geometry import unpack_parts
from multi_part_assembly_tpu_torch.datasets.partnet import (
    PartNetPartDataset, build_partnet_dataloader, enable_device_table)
from multi_part_assembly_tpu_torch.train import trainer as ttrainer
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'scripts'))
PN_CFG = os.path.join(ROOT, 'configs/pn_transformer/pn_transformer/'
                      'pn_transformer-32x1-cosine_400e-partnet_chair.py')
P, N = 8, 24
KEY_SETS = {
    'chair': ('part_ids', 'match_ids', 'contact_points'),
    'all': ('part_label', 'part_ids', 'match_ids', 'contact_points', 'sym',
            'valid_matrix'),
}
CPU, CUDA = torch.device('cpu'), torch.device('cuda')


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    from make_synthetic_data import generate_partnet
    root = str(tmp_path_factory.mktemp('partnet'))
    generate_partnet(root, n_shapes=10, min_parts=2, max_parts=P,
                     num_points=N, seed=3, same_val=False,
                     split_prefix='Chair.')
    # one shape over max_num_part, which both filters drop
    extra = str(tmp_path_factory.mktemp('extra'))
    generate_partnet(extra, n_shapes=1, min_parts=P + 2,
                     max_parts=P + 2, num_points=N, seed=4)
    data = np.load(os.path.join(extra, 'shape_data', '10000_level3.npy'),
                   allow_pickle=True).item()
    np.save(os.path.join(root, 'shape_data', '19999_level3.npy'), data,
            allow_pickle=True)
    ids = np.load(os.path.join(root, 'Chair.train.npy'))
    np.save(os.path.join(root, 'Chair.train.npy'), np.append(ids, 19999))
    return root


def _pair(tree, keys, shuffle=False, split='train'):
    kw = dict(data_dir=tree, data_fn=f'Chair.{split}.npy',
              data_keys=KEY_SETS[keys], num_part_category=20,
              min_num_part=2, max_num_part=P, shuffle_parts=shuffle)
    return JaxDataset(**kw), PartNetPartDataset(**kw)


def _equal(ours, ref, skip=()):
    assert set(ours) - set(skip) == set(ref) - set(skip)
    for k, v in ref.items():
        if k in skip:
            continue
        a, b = np.asarray(ours[k]), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize('keys', sorted(KEY_SETS))
def test_items_match_jax(tree, keys):
    jds, tds = _pair(tree, keys)
    assert tds.shape_ids == jds.shape_ids and len(tds) == 8
    for i in range(len(tds)):
        _equal(tds[i], jds[i])
    item = tds[0]
    assert item['instance_label'].shape == (P, P)
    assert item['part_label'].shape == \
        ((P, 20) if keys == 'all' else (P, 0))
    assert item['part_ids'].dtype == np.float32


@pytest.mark.parametrize('shuffle', [False, True])
@pytest.mark.parametrize('keys', sorted(KEY_SETS))
def test_host_wire_batches_match_jax(tree, keys, shuffle):
    """The port ships exactly K packed rows; JAX pads them to a bucket with
    zero rows.  Rows, index and labels bit for bit; the unpacked clouds
    too."""
    jds, tds = _pair(tree, keys, shuffle)
    for idx in ([0, 1, 2, 3], [4, 7, 5]):
        np.random.seed(9)
        ref = jds.collate_batch(idx)
        np.random.seed(9)
        ours = tds.collate_batch(idx)
        K = ours['part_pcs__packed'].shape[0]
        assert K == int(ours['part_valids'].sum())
        assert ours['part_pcs__packed'].dtype == np.float16
        np.testing.assert_array_equal(ours['part_pcs__packed'],
                                      ref['part_pcs__packed'][:K])
        assert not ref['part_pcs__packed'][K:].any()
        _equal(ours, ref, skip=('part_pcs__packed', ))
        dense = unpack_parts(
            torch.tensor(ours['part_pcs__packed']).float(),
            torch.tensor(ours['pack_index']),
            torch.tensor(ours['part_valids']))
        ref_dense = np.asarray(jax_unpack(
            jnp.asarray(ref['part_pcs__packed']),
            jnp.asarray(ref['pack_index']), jnp.asarray(ref['part_valids'])))
        np.testing.assert_array_equal(dense.numpy(), ref_dense)


@pytest.mark.parametrize('shuffle', [False, True])
def test_slot_wire_batches_and_gather_match_jax(tree, shuffle):
    """Slots and labels bit for bit; the port's f16 table gathers JAX's
    split-plane sum bit for bit, and the host wire's clouds."""
    jds, tds = _pair(tree, 'chair', shuffle)
    jtab = JPT.build_part_table(jds)
    ttab = TPT.build_part_table(tds, 'cpu')
    assert ttab.table.dtype == torch.float16
    assert ttab.table.shape == (int(np.sum(
        [tds._load_raw(s)['part_pcs'].shape[0] for s in tds.shape_ids])),
        N, 3)
    np.testing.assert_array_equal(ttab.slot_base, jtab.slot_base)
    jds._device_ptable, tds._device_ptable = jtab, ttab
    for idx in ([0, 1, 2, 3], [6, 2, 5]):
        np.random.seed(5)
        ref = jds.collate_batch(idx)
        np.random.seed(5)
        ours = tds.collate_batch(idx)
        assert ours.pop('__ptable__') is ttab
        ref.pop('__ptable__')
        _equal(ours, ref)
        got = TPT.gather_part_table(ttab.table,
                                    torch.tensor(ours['part_slots']),
                                    torch.tensor(ours['part_valids']))
        want = np.asarray(JPT.gather_part_table(
            jtab.table, jnp.asarray(ref['part_slots']),
            jnp.asarray(ref['part_valids'])))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        # the same clouds as the host wire's
        tds._device_ptable = None
        np.random.seed(5)
        host = tds.collate_batch(idx)
        tds._device_ptable = ttab
        dense = unpack_parts(torch.tensor(host['part_pcs__packed']).float(),
                             torch.tensor(host['pack_index']),
                             torch.tensor(host['part_valids']))
        assert torch.equal(dense, got)


def test_build_part_table_takes_its_device_and_budget(tree):
    _, tds = _pair(tree, 'chair')
    with pytest.raises(TypeError):
        TPT.build_part_table(tds)  # the device has no default
    assert TPT.build_part_table(tds, 'cpu', budget_bytes=100) is None
    table = TPT.build_part_table(tds, 'cpu')
    assert table.nbytes == table.table.numel() * 2


def _chair_cfg(tree, *opts):
    cfg = TCFG.load_cfg_file(PN_CFG).merge_from_list([
        'data.data_dir', tree, 'data.max_num_part', str(P),
        'data.num_pc_points', str(N), 'exp.batch_size', '2',
        'model.pc_feat_dim', '16', 'model.transformer_feat_dim', '32',
        'model.transformer_heads', '2', 'model.transformer_layers', '1',
        *opts])
    cfg.exp.bf16 = False
    return cfg


def test_build_dataloader_dispatches_and_enables_the_table(tree):
    cfg = _chair_cfg(tree)
    train, val = build_dataloader(cfg)
    assert isinstance(train.dataset, PartNetPartDataset)
    assert (train.batch_size, val.batch_size) == (2, 4)
    assert train.shuffle and train.drop_last and not val.shuffle
    assert len(train) == 4 and len(val) == 1
    table = enable_device_table(train, cfg, 'cpu')
    assert table is train.dataset._device_ptable
    assert enable_device_table(train, cfg, 'cpu') is table  # built once
    batch = next(iter(train))
    assert 'part_slots' in batch and 'part_pcs__packed' not in batch
    geo = TCFG.load_cfg_file(os.path.join(
        ROOT, 'configs/pn_transformer/pn_transformer/'
        'pn_transformer-32x1-cosine_400e-everyday.py'))
    with pytest.raises(NotImplementedError, match='nosuch'):
        geo.data.dataset = 'nosuch'
        build_dataloader(geo)
    assert build_partnet_dataloader(cfg)[0].dataset.shape_ids == \
        train.dataset.shape_ids


def _cfg(dataset='partnet', **data):
    return TCFG.CN({'data': {'dataset': dataset, **data}})


@pytest.mark.parametrize('value,device,dataset,expected', [
    (True, CPU, 'partnet', True),
    (False, CUDA, 'partnet', False),
    ('auto', CUDA, 'partnet', True),
    ('auto', CPU, 'partnet', False),
    ('auto', CUDA, 'geometry', False),
    (None, CUDA, 'partnet', True),   # key absent: 'auto'
    ('TRUE', CPU, 'partnet', True),
    ('False', CUDA, 'partnet', False),
    ('Auto', CUDA, 'partnet', True),
])
def test_device_table_reading(value, device, dataset, expected):
    cfg = _cfg(dataset) if value is None else \
        _cfg(dataset, device_table=value)
    assert ttrainer.device_table_enabled(cfg, device) is expected


@pytest.mark.parametrize('value', ['yes', 'on', '', 1, 0.0])
def test_device_table_other_values_raise(value):
    with pytest.raises(ValueError, match='device_table'):
        ttrainer.device_table_enabled(_cfg(device_table=value), CPU)


def test_trainer_wires_give_the_same_step(tree, tmp_path):
    """A PartNet Trainer on the CPU: the host wire by default, the slot
    wire with data.device_table True; one train step on each from the same
    seed gives the same loss, bit for bit, and no geometric augmentation
    (the GT poses are the dataset's)."""
    losses = {}
    for word in ('False', 'True'):
        cfg = _chair_cfg(tree, 'data.device_table', word)
        t = ttrainer.Trainer(cfg, 'cpu', ckp_dir=str(tmp_path / word),
                             resume=False, quiet=True)
        assert (t.part_tables['train'] is not None) == (word == 'True')
        assert t.tables == {'train': None, 'val': None}
        t.train_loader.set_epoch(0)
        batch = next(iter(t.train_loader))
        data = t._augment(dict(batch))
        np.testing.assert_array_equal(data['part_quat'].numpy(),
                                      batch['part_quat'].numpy())
        assert data['part_pcs'].shape == (2, P, N, 3)
        losses[word] = t.train_step(batch)['loss']
        t.close()
    assert losses['True'] == losses['False']
    assert np.isfinite(losses['True'])
