"""The port's host data path held against the JAX package's on the CPU.

  - the native sampler's f16 store: `sample_batch(out=)` in f16 and f32
    equals JAX `MeshSampler`'s bit for bit, and the f16 rows are exactly
    f16 of the f32 rows; the bulk `f32_to_f16` equals numpy's rounding;
  - the packed host collate (`collate_batch` without tables): rows, part
    counts and ids equal JAX `collate_batch`'s first K rows bit for bit, in
    f16 and f32, and `expand_geometry_batch` of them equals JAX's; the f32
    wire expands to the dense items' clouds bit for bit;
  - the flagship config's loaders take the packed f16 wire;
  - PartNet's packed rows keep their bits through the native conversion;
  - the flagship MoN step fed the same f16 batch and the same rotations
    matches JAX's: loss 1e-4 relative, gradients 1e-3 relative L2;
  - the loader: its batches are JAX's `DataLoader(batch_collate=True)`
    batches in JAX's order, bit for bit, one native sampling call each; an
    error in either producer stage reaches the consumer; no thread
    outlives an abandoned iterator;
  - the trainer's placement stage (`DevicePlacement`) gives batches equal
    bit for bit to the inline `_device_batch` on every wire.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_datasets import bb_tree  # noqa: F401 (fixture)
from test_torch_partnet import _pair, tree  # noqa: F401 (fixture)
from test_torch_train_step import (B, FLAGSHIP, N, OPTS, P, _jax_step,
                                   _torch_step, no_dropout_f32,  # noqa: F401
                                   synth)  # noqa: F401 (fixtures)

from multi_part_assembly_tpu.datasets import GeometryPartDataset as JaxDataset
from multi_part_assembly_tpu.datasets import geometry as jgeo
from multi_part_assembly_tpu.datasets import mesh_io as jmesh
from multi_part_assembly_tpu.datasets.loader import DataLoader as JaxLoader
from multi_part_assembly_tpu_torch.datasets import build_dataloader
from multi_part_assembly_tpu_torch.datasets import geometry as tgeo
from multi_part_assembly_tpu_torch.datasets import mesh_io as tmesh
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.train import trainer as ttrainer
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG

torch.set_num_threads(2)

KEYS = ('part_ids', 'valid_matrix')
DTYPES = ['float16', 'float32']


def _datasets(root, **kw):
    kw = dict(data_dir=root, data_fn='everyday.train.txt', data_keys=KEYS,
              num_points=N, max_num_part=P, **kw)
    return tgeo.GeometryPartDataset(**kw), JaxDataset(**kw)


def _mesh_paths(root):
    ours, _ = _datasets(root)
    return ours.all_mesh_paths()


# ---------------------------------------------------------------------------
# the native sampler's f16 store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('dtype', DTYPES)
def test_sample_batch_out_matches_jax(bb_tree, dtype):  # noqa: F811
    paths = _mesh_paths(bb_tree)
    seeds = [7 + 64 * i for i in range(len(paths))]
    ours, ref = tmesh.MeshSampler(), jmesh.MeshSampler()
    assert ours.is_native and ref.is_native
    a = np.full((len(paths), 100, 3), 9, dtype)
    b = np.full((len(paths), 100, 3), 9, dtype)
    assert ours.sample_batch(paths, 100, seeds, out=a) is a
    ref.sample_batch(paths, 100, seeds, out=b)
    assert a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes()
    f32 = ours.sample_batch(paths, 100, seeds)
    assert f32.dtype == np.float32
    np.testing.assert_array_equal(f32.astype(dtype).view(np.uint8),
                                  a.view(np.uint8))
    # one mesh at a time gives the same rows as the threaded batch
    for i, (path, seed) in enumerate(zip(paths, seeds)):
        one = np.empty((1, 100, 3), dtype)
        ours.sample_batch([path], 100, [seed], out=one)
        np.testing.assert_array_equal(one[0].view(np.uint8),
                                      a[i].view(np.uint8))


def test_sample_batch_out_is_checked(bb_tree):  # noqa: F811
    paths = _mesh_paths(bb_tree)[:2]
    sampler = tmesh.MeshSampler()
    for bad in (np.empty((2, 10, 3), np.float64),
                np.empty((3, 10, 3), np.float16),
                np.empty((2, 10, 6), np.float16)[..., :3]):
        with pytest.raises(ValueError, match='out mismatch'):
            sampler.sample_batch(paths, 10, [1, 2], out=bad)


def test_numpy_fallback_rounds_to_the_f16_grid(bb_tree,  # noqa: F811
                                               monkeypatch):
    """Without the native library the f16 rows are numpy's rounding of the
    numpy sampler's f32 rows."""
    paths = _mesh_paths(bb_tree)[:3]
    sampler = tmesh.MeshSampler()
    monkeypatch.setattr(sampler, '_lib', None)
    f16 = np.empty((3, 50, 3), np.float16)
    sampler.sample_batch(paths, 50, [1, 2, 3], out=f16)
    f32 = sampler.sample_batch(paths, 50, [1, 2, 3])
    np.testing.assert_array_equal(f16, f32.astype(np.float16))


def _f16_edge_values():
    rng = np.random.default_rng(0)
    halfs = np.arange(0, 1 << 16, dtype=np.uint16).view(np.float16)
    halfs = halfs[np.isfinite(halfs)].astype(np.float32)
    # the midpoints between neighbouring halves: the ties to even
    mids = ((halfs[:-1].astype(np.float64) + halfs[1:]) / 2).astype(
        np.float32)
    return np.concatenate([
        halfs, mids, np.nextafter(mids, np.float32(np.inf)),
        np.nextafter(mids, np.float32(-np.inf)),
        rng.normal(size=4099).astype(np.float32),
        np.float32([6.6e4, -7e4, 1e-8, -3e-8, 0.0, -0.0])])


def test_f32_to_f16_matches_numpy_and_jax():
    src = np.ascontiguousarray(_f16_edge_values()).reshape(-1)
    ours = tmesh.f32_to_f16(src, np.empty(src.shape, np.float16))
    ref = jmesh.f32_to_f16(src, np.empty(src.shape, np.float16))
    with np.errstate(over='ignore'):  # 6.6e4 and -7e4 round to infinities
        want = src.astype(np.float16)
    np.testing.assert_array_equal(ours.view(np.uint16), want.view(np.uint16))
    np.testing.assert_array_equal(ours.view(np.uint16), ref.view(np.uint16))
    with pytest.raises(ValueError):
        tmesh.f32_to_f16(src, np.empty(src.shape, np.float32))


# ---------------------------------------------------------------------------
# the packed host collate and its expansion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('epoch,indices', [(0, [0, 1, 2]), (3, [2, 0]),
                                           (7, [1])])
def test_packed_collate_matches_jax(bb_tree, dtype, epoch,  # noqa: F811
                                    indices):
    ours, ref = _datasets(bb_tree, wire_dtype=dtype)
    ours.set_epoch(epoch)
    ref.set_epoch(epoch)
    a, b = ours.collate_batch(indices), ref.collate_batch(indices)
    assert set(a) == {'part_pcs_raw__packed', 'part_counts', 'data_id'}
    K = int(a['part_counts'].sum())
    rows = a['part_pcs_raw__packed']
    assert rows.shape == (K, N, 3) and rows.dtype == np.dtype(dtype)
    assert rows.flags['C_CONTIGUOUS']
    want = b['part_pcs_raw__packed'][:K]
    np.testing.assert_array_equal(rows.view(np.uint8), want.view(np.uint8))
    assert not b['part_pcs_raw__packed'][K:].any()  # JAX's Kpad padding
    for key in ('part_counts', 'data_id'):
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])
    # the expansion on the device, f32 whatever the wire
    got = tgeo.expand_geometry_batch(torch.from_numpy(rows),
                                     torch.from_numpy(a['part_counts']),
                                     max_parts=P, data_keys=KEYS)
    want = jgeo.expand_geometry_batch(
        jnp.asarray(b['part_pcs_raw__packed']), jnp.asarray(b['part_counts']),
        max_parts=P, data_keys=KEYS)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_f32_wire_expands_to_the_items(bb_tree):  # noqa: F811
    """`data.wire_dtype float32` gives the dense items' batch bit
    for bit; f16 gives its clouds on the f16 grid."""
    for dtype in DTYPES:
        ours, _ = _datasets(bb_tree, wire_dtype=dtype)
        ours.set_epoch(2)
        a = ours.collate_batch([2, 0, 1])
        got = tgeo.expand_geometry_batch(
            torch.from_numpy(a['part_pcs_raw__packed']),
            torch.from_numpy(a['part_counts']), max_parts=P, data_keys=KEYS)
        items = [ours[i] for i in (2, 0, 1)]
        items = {k: np.stack([it[k] for it in items]) for k in items[0]}
        for k in ('part_valids', 'instance_label', 'part_label') + KEYS:
            np.testing.assert_array_equal(got[k].numpy(), items[k],
                                          err_msg=k)
        want = items['part_pcs_raw']
        if dtype == 'float16':
            want = want.astype(np.float16).astype(np.float32)
        np.testing.assert_array_equal(got['part_pcs_raw'].numpy(), want)


def test_bad_wire_dtype_raises(bb_tree):  # noqa: F811
    with pytest.raises(ValueError, match='wire_dtype'):
        _datasets(bb_tree, wire_dtype='bfloat16')


def test_default_config_takes_the_f16_wire(synth):  # noqa: F811
    cfg = TCFG.load_cfg_file(FLAGSHIP).merge_from_list(
        OPTS + ['data.data_dir', synth, 'exp.batch_size', '2'])
    assert 'wire_dtype' not in cfg.data
    train, val = build_dataloader(cfg)
    for loader in (train, val):
        assert loader.dataset.wire_dtype == np.float16
    train.set_epoch(0)
    batch = next(iter(train))
    K = int(batch['part_counts'].sum())
    assert batch['part_pcs_raw__packed'].dtype == torch.float16
    assert batch['part_pcs_raw__packed'].shape == (K, N, 3)
    cfg.data.wire_dtype = 'float32'
    train, _ = build_dataloader(cfg)
    assert next(iter(train))['part_pcs_raw__packed'].dtype == torch.float32


def test_partnet_rows_keep_their_bits(tree):  # noqa: F811
    """The PartNet host wire converts its clouds by the native f16 pass;
    the rows are numpy's `astype(np.float16)` of them, bit for bit, and
    JAX's first K rows."""
    for dtype in DTYPES:
        jds, tds = _pair(tree, 'chair')
        tds.wire_dtype = np.dtype(dtype)
        for idx in ([0, 1, 2, 3], [4, 7, 5]):
            ours, ref = tds.collate_batch(idx), jds.collate_batch(idx)
            rows = ours['part_pcs__packed']
            clouds = np.concatenate([
                np.asarray(tds._load_raw(tds.shape_ids[i])['part_pcs'],
                           np.float32) for i in idx])
            assert rows.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(
                rows.view(np.uint8), clouds.astype(dtype).view(np.uint8))
            if dtype == 'float16':
                K = rows.shape[0]
                np.testing.assert_array_equal(
                    rows.view(np.uint16),
                    ref['part_pcs__packed'][:K].view(np.uint16))


# ---------------------------------------------------------------------------
# the flagship step on the f16 wire
# ---------------------------------------------------------------------------


def test_flagship_step_on_the_f16_wire_matches_jax(
        no_dropout_f32, bb_tree):  # noqa: F811
    """The same f16 packed batch through both collates and expansions (bit
    for bit), then the MoN step with JAX's rotations injected: loss within
    1e-4 relative, the gradients within 1e-3 relative L2, each parameter's
    and all together."""
    ours_ds, ref_ds = _datasets(bb_tree)
    assert len(ours_ds) == B and ours_ds.wire_dtype == np.float16
    ours_ds.set_epoch(1)
    ref_ds.set_epoch(1)
    a, b = ours_ds.collate_batch(list(range(B))), \
        ref_ds.collate_batch(list(range(B)))
    jb = jgeo.expand_geometry_batch(
        jnp.asarray(b['part_pcs_raw__packed']), jnp.asarray(b['part_counts']),
        max_parts=P, data_keys=KEYS)
    raw, valids = np.asarray(jb['part_pcs_raw']), np.asarray(
        jb['part_valids'])
    tb = tgeo.expand_geometry_batch(
        torch.from_numpy(a['part_pcs_raw__packed']),
        torch.from_numpy(a['part_counts']), max_parts=P, data_keys=KEYS)
    np.testing.assert_array_equal(tb['part_pcs_raw'].numpy(), raw)
    np.testing.assert_array_equal(tb['part_valids'].numpy(), valids)
    ref = _jax_step(raw, valids)
    ours = _torch_step(tb['part_pcs_raw'].numpy(),
                       tb['part_valids'].numpy(), ref)
    loss, ref_loss = float(ours['logs']['loss'].detach()), \
        float(ref['logs']['loss'])
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss), (loss, ref_loss)
    ref_grads = jax_to_state_dict({'params': ref['grads'],
                                   'batch_stats': ref['var']['batch_stats']})
    names = sorted(ours['grads'])
    got = torch.cat([ours['grads'][n].reshape(-1) for n in names]).double()
    want = torch.cat([ref_grads[n].reshape(-1) for n in names]).double()
    assert float((got - want).norm() / want.norm()) <= 1e-3
    for n in names:
        g, w = ours['grads'][n].double(), ref_grads[n].double()
        # a parameter whose gradient is float noise (the attention's key
        # bias has an exactly zero true gradient) only within the whole's
        assert float((g - w).norm()) <= 1e-3 * max(float(w.norm()),
                                                   1e-6 * float(want.norm()))


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('split', ['train', 'val'])
def test_loader_matches_jax(bb_tree, split):  # noqa: F811
    """The loader's packed batches are JAX's packed loader's (one process,
    one device: `batch_collate`), in its order: the first K rows, counts
    and ids bit for bit."""
    ours_ds, ref_ds = _datasets(bb_tree)
    kw = dict(batch_size=2, shuffle=True, drop_last=True, seed=5) \
        if split == 'train' else \
        dict(batch_size=2, shuffle=False, drop_last=False, seed=5)
    ours = tgeo.DataLoader(ours_ds, **kw)
    ref = JaxLoader(ref_ds, num_workers=1, batch_collate=True, **kw)
    assert ref.batch_collate and len(ours) == len(ref)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            K = int(w['part_counts'].sum())
            rows = g['part_pcs_raw__packed'].numpy()
            assert rows.shape[0] == K
            np.testing.assert_array_equal(
                rows.view(np.uint16),
                w['part_pcs_raw__packed'][:K].view(np.uint16))
            for k in ('part_counts', 'data_id'):
                assert g[k].numpy().dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)


def test_one_native_call_a_batch(bb_tree, monkeypatch):  # noqa: F811
    """The host wire samples a batch's K part meshes in one call of the
    native sampler, with the items' seeds, straight into the wire rows."""
    ours, _ = _datasets(bb_tree)
    calls = []
    real = ours.sampler.sample_batch

    def counted(paths, n_points, seeds, out=None):
        calls.append((len(paths), list(seeds), out))
        return real(paths, n_points, seeds, out=out)

    monkeypatch.setattr(ours.sampler, 'sample_batch', counted)
    loader = tgeo.DataLoader(ours, batch_size=2, shuffle=True, seed=1)
    loader.set_epoch(3)
    batches = list(loader)
    assert len(calls) == len(batches) == len(loader)
    for (k, seeds, out), b in zip(calls, batches):
        assert k == int(b['part_counts'].sum()) == len(seeds)
        assert out.dtype == np.float16 and out.shape == (k, N, 3)
        want = [ours._epoch_seed + i * 64 + j
                for i, n in zip(b['data_id'].tolist(),
                                b['part_counts'].tolist())
                for j in range(n)]
        assert seeds == want


class _Items:
    """Batches of their indices; `fail_at` raises in the collate."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass

    def collate_batch(self, indices):
        if self.fail_at in indices:
            raise KeyError(f'batch of {self.fail_at}')
        return {'i': np.asarray(indices, np.int64)}


def _loader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith('loader-')]


@pytest.mark.parametrize('stage,at', [('collate', 6), ('collate', 0),
                                      ('transform', 6)])
def test_producer_errors_reach_the_consumer(stage, at):
    def transform(batch):
        if stage == 'transform' and at in batch['i'].tolist():
            raise RuntimeError('placement failed')
        return {'i': batch['i'] * 10}

    ds = _Items(12, fail_at=None if stage == 'transform' else at)
    loader = tgeo.DataLoader(ds, batch_size=2, transform=transform)
    seen = []
    with pytest.raises(RuntimeError if stage == 'transform' else KeyError):
        for batch in loader:
            seen.append(batch['i'].tolist())
    assert seen == [[0, 10], [20, 30], [40, 50]][:at // 2]
    _wait_no_loader_threads()


def _wait_no_loader_threads():
    deadline = time.monotonic() + 10
    while _loader_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _loader_threads()


@pytest.mark.parametrize('transform', [False, True])
def test_abandoned_iterator_leaves_no_thread(transform, monkeypatch):
    """Both stages stop, and are joined, when the consumer closes the
    iterator while they wait on full queues."""
    monkeypatch.setattr(tgeo, '_PREFETCH', 1)
    loader = tgeo.DataLoader(_Items(40), batch_size=2,
                             transform=(lambda b: b) if transform else None)
    it = iter(loader)
    assert next(it)['i'].tolist() == [0, 1]
    time.sleep(0.3)  # the stages fill their queues and wait
    assert len(_loader_threads()) == (2 if transform else 1)
    it.close()
    assert not _loader_threads()  # joined by the close itself
    # an iterator dropped after one batch
    assert next(iter(loader))['i'].tolist() == [0, 1]
    _wait_no_loader_threads()


def test_loader_stress_in_order_and_joined(monkeypatch):
    """Many iterators, each abandoned after a random number of batches,
    under a tiny thread switch interval: every batch arrives once and in
    order, the transform ran on each, and no stage outlives its iterator."""
    import sys
    rng = np.random.default_rng(0)
    monkeypatch.setattr(tgeo, '_PREFETCH', 1)
    loader = tgeo.DataLoader(_Items(64), batch_size=2,
                             transform=lambda b: {'i': b['i'] + 1000})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        for _ in range(40):
            take = int(rng.integers(0, 33))
            it = iter(loader)
            got = [next(it)['i'].tolist() for _ in range(take)]
            it.close()
            assert got == [[1000 + 2 * k, 1001 + 2 * k]
                           for k in range(take)]
            assert not _loader_threads()
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(interval)


def test_transform_runs_on_its_own_thread():
    names = set()

    def transform(batch):
        names.add(threading.current_thread().name)
        return batch

    loader = tgeo.DataLoader(_Items(8), batch_size=2, transform=transform)
    assert [b['i'].tolist() for b in loader] == [[0, 1], [2, 3], [4, 5],
                                                 [6, 7]]
    assert names == {'loader-transform'}


# ---------------------------------------------------------------------------
# the trainer's placement stage
# ---------------------------------------------------------------------------


WIRES = {
    'host f16': [],
    'host f32': ['data.wire_dtype', 'float32'],
    'dense slots': ['data.device_sampling', 'True',
                    'data.device_table_layout', 'dense'],
    'chunked slots': ['data.device_sampling', 'True',
                      'data.device_table_layout', 'chunked'],
}


def _trainer(synth_dir, tmp_path, opts):
    cfg = TCFG.load_cfg_file(FLAGSHIP).merge_from_list(
        OPTS + ['data.data_dir', synth_dir, 'exp.batch_size', '2',
                'data.num_pc_points', '16', *opts])
    cfg.exp.bf16 = False
    return ttrainer.Trainer(cfg, 'cpu', ckp_dir=str(tmp_path), resume=False,
                            quiet=True)


@pytest.mark.parametrize('wire', sorted(WIRES))
def test_placed_batches_equal_inline(synth, tmp_path, wire):  # noqa: F811
    trainer = _trainer(synth, tmp_path, WIRES[wire])
    for loader in (trainer.train_loader, trainer.val_loader):
        assert isinstance(loader.transform, ttrainer.DevicePlacement)
        loader.set_epoch(1)
        placed = list(loader)
        transform, loader.transform = loader.transform, None
        try:
            host = list(loader)
        finally:
            loader.transform = transform
        assert len(placed) == len(host) == len(loader)
        for p, h in zip(placed, host):
            assert p[ttrainer._READY] is None  # no streams on the CPU
            assert torch.equal(p['data_id'], h['data_id'])  # rides along
            if wire.startswith('host'):
                assert 'part_pcs_raw__packed' in h
            else:
                assert 'part_slots__packed' in h
            got = trainer._device_batch(p)
            want = trainer._device_batch(h)
            assert ttrainer._READY in p  # the batch is left as it was
            assert set(got) == set(want) and 'part_pcs_raw' in got
            for k, v in want.items():
                assert got[k].dtype == v.dtype, k
                assert torch.equal(got[k], v), k
    # one epoch of steps on the placed batches, and one more inline
    logs = trainer.train_epoch(0)
    trainer.close()
    assert logs is not None and np.isfinite(logs['loss'])


def test_placed_partnet_batches_equal_inline(tree, tmp_path):  # noqa: F811
    from test_torch_partnet import _chair_cfg
    for word in ('False', 'True'):
        t = ttrainer.Trainer(_chair_cfg(tree, 'data.device_table', word),
                             'cpu', ckp_dir=str(tmp_path / word),
                             resume=False, quiet=True)
        loader = t.train_loader
        loader.set_epoch(0)
        placed = next(iter(loader))
        loader.transform = None
        host = next(iter(loader))
        got, want = t._device_batch(placed), t._device_batch(host)
        assert set(got) == set(want) and 'part_pcs' in got
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        t.close()


def test_placement_error_surfaces(synth, tmp_path,  # noqa: F811
                                  monkeypatch):
    """A failure in the placement stage is raised in the training loop; the
    trainer does not place the batch itself instead."""
    trainer = _trainer(synth, tmp_path, [])
    calls = []

    def failing(batch, cfg, device):
        calls.append(threading.current_thread().name)
        raise RuntimeError('no room on the device')

    monkeypatch.setattr(ttrainer, 'device_batch', failing)
    with pytest.raises(RuntimeError, match='no room'):
        trainer.train_epoch(0)
    assert calls == ['loader-transform']
    assert trainer.step == 0
    _wait_no_loader_threads()
    trainer.close()


def test_pinned_view_is_taken_back_uncopied():
    """`_to_tensors` gives back the tensor a `wire_array` views instead of
    copying it (pinned memory needs a card; here the array is plain)."""
    arr = tgeo.wire_array((3, 4, 3), np.float16)
    assert arr.dtype == np.float16 and arr.shape == (3, 4, 3)
    out = tgeo._to_tensors({'x': arr, 'n': np.int32(3), 'o': 'tables'},
                           pin=False)
    assert out['x'].data_ptr() == arr.ctypes.data
    assert out['o'] == 'tables' and int(out['n']) == 3
    if torch.cuda.is_available():  # pragma: no cover - on the card
        pinned = tgeo.wire_array((3, 4, 3), np.float16)
        assert tgeo._to_tensors({'x': pinned}, pin=True)['x'].data_ptr() \
            == pinned.ctypes.data
