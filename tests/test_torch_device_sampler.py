"""The port's device-sampling wire held against the JAX package.

The same meshes, slots and uniforms (made with numpy from a seed) go
through both packages on the CPU: the JAX side as tests/test_device_sampler.py
runs it (the Pallas kernel in interpret mode, and `sample_packed_ref`), the
port's side through the plain versions of kernels B5/B6.

Tolerances: tables, layouts, face draws, the slot collate and the
expansion exactly; points to atol 1e-6 against JAX (its interpret-mode
kernel selects table values by an f32 one-hot matmul, and XLA may contract
the barycentric mix into FMAs), and bit for bit between the port's dense
and chunked layouts, which compute the same rounded operations on the same
values.  The sampled train step uses test_torch_train_step.py's tolerances.
Plus the repairs: the trainer's explicit device and its reading of
`data.device_sampling`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_datasets import _write_cube, bb_tree  # noqa: F401 (fixture)
from test_device_sampler import _write_soup
from test_torch_train_step import (B, FLAGSHIP, N, OPTS, P, _jax_step,
                                   _torch_step, no_dropout_f32,  # noqa: F401
                                   synth)  # noqa: F401 (fixtures)

from multi_part_assembly_tpu.datasets import GeometryPartDataset as JaxDataset
from multi_part_assembly_tpu.datasets import device_sampler as dsmp
from multi_part_assembly_tpu.datasets import geometry as jgeo
from multi_part_assembly_tpu.datasets.mesh_io import MeshSampler
from multi_part_assembly_tpu_torch.datasets import device_sampler as tds
from multi_part_assembly_tpu_torch.datasets import geometry as tgeo
from multi_part_assembly_tpu_torch.datasets.mesh_io import \
    MeshSampler as TorchMeshSampler
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.train import trainer as ttrainer
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG

SOUP_FACES = [300, 128, 37, 520]  # ragged around a chunk width of 128
KEYS = ('part_ids', 'valid_matrix')


def _cubes(folder, n=3):
    paths = []
    for i in range(n):
        p = str(folder / f'cube{i}.obj')
        _write_cube(p, scale=0.5 + 0.25 * i, offset=0.3 * i)
        paths.append(p)
    return paths


def _soups(folder, faces, seed0=0):
    paths = []
    for i, nf in enumerate(faces):
        p = str(folder / f'soup{seed0 + i}.obj')
        _write_soup(p, nf, seed=seed0 + i)
        paths.append(p)
    return paths


@pytest.fixture(scope='module')
def meshes(tmp_path_factory):
    folder = tmp_path_factory.mktemp('meshes')
    return {'cubes': _cubes(folder), 'soups': _soups(folder, SOUP_FACES)}


def _both_tables(paths, **kw):
    return (tds.build_device_tables(paths, TorchMeshSampler(), 'cpu', **kw),
            dsmp.build_device_tables(paths, MeshSampler(), **kw))


def _uniforms(K, npad, seed):
    """[K, 8, Npad] f32 in the JAX kernel's layout; the port takes rows
    0-2 of the first N columns."""
    return np.random.default_rng(seed).random((K, 8, npad), np.float32)


def _np_draws(table, n_faces, slots, u0):
    """The face draw in numpy f32 (a third implementation of the alias
    rule): the sampled face for a dense table, for a chunked one f0 where
    the alias test kept it and -1 - f0 where it took the alias triangle."""
    chunked = table.shape[1] == dsmp._N_ROWS_C
    nf = n_faces[dsmp._META_NF] if chunked else n_faces
    F = nf[slots].astype(np.float32)[:, None]
    rf = u0 * F
    f0 = np.minimum(np.floor(rf), F - np.float32(1.0))
    frac = rf - f0
    f0 = f0.astype(np.int64)
    if chunked:
        fc = table.shape[2]
        row = n_faces[dsmp._META_BASE][slots][:, None] + f0 // fc
        prob = table[row, dsmp._CROW_PROB, f0 % fc]
        return np.where(frac < prob, f0, -1 - f0)
    s = slots[:, None]
    prob = table[s, dsmp._ROW_PROB, f0]
    alias = table[s, dsmp._ROW_ALIAS, f0]
    return np.where(frac < prob, f0,
                    (alias + np.float32(0.5)).astype(np.int64))


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('layout,chunk_f', [('dense', 512), ('chunked', 512),
                                            ('chunked', 128)])
@pytest.mark.parametrize('mesh_set', ['cubes', 'soups'])
def test_tables_match_jax(meshes, mesh_set, layout, chunk_f):
    ours, ref = _both_tables(meshes[mesh_set], layout=layout, chunk_f=chunk_f)
    assert ours.layout == layout
    np.testing.assert_array_equal(tds.jax_table(ours.table).numpy(),
                                  np.asarray(ref.table))
    np.testing.assert_array_equal(ours.n_faces.numpy(),
                                  np.asarray(ref.n_faces))
    assert ours.n_faces.dtype == torch.int32
    assert ours.slot_of == ref.slot_of and ours.fmax == ref.fmax
    # each table is stored once, face-major: the dense one as its 48-byte
    # records (12 floats a face, not the JAX table's 16), the chunked one
    # as the records its table is a view of
    assert tds.table_records(ours.table).is_contiguous()
    if layout == 'dense':
        n, _, fmax = ref.table.shape
        assert ours.table.shape == (n, fmax, 3, 4)
        assert ours.nbytes == ref.nbytes - n * fmax * 4 * 4
    else:
        assert not ours.table.is_contiguous()
        assert ours.nbytes == ref.nbytes


# (soup face counts, budget bytes, chunk width): the cases of
# test_device_sampler.py::test_chunked_budget_auto and the cube budget
AUTO_CASES = [
    ([600, 20, 20, 20], 200_000, 128),   # both fit, skew -> chunked
    ([600, 20, 20, 20], 120_000, 128),   # only chunked fits
    ([600, 20, 20, 20], 50_000, 128),    # neither fits -> None
    ([20, 20, 20], 250_000, 512),        # uniform small -> dense
    ([20, 20, 20, 1200], 300_000, 512),  # dense over budget -> chunked
    ([12], 64, 512),                     # nothing fits -> None
]


@pytest.mark.parametrize('faces,budget,chunk_f', AUTO_CASES)
def test_auto_layout_matches_jax(tmp_path, faces, budget, chunk_f):
    paths = _soups(tmp_path, faces, seed0=10)
    ours, ref = _both_tables(paths, budget_bytes=budget, chunk_f=chunk_f)
    assert (ours is None) == (ref is None)
    if ref is not None:
        assert ours.layout == ('chunked' if ref.table.shape[1] == 24
                               else 'dense')
        np.testing.assert_array_equal(tds.jax_table(ours.table).numpy(),
                                      np.asarray(ref.table))


def test_no_paths_and_bad_layout():
    assert tds.build_device_tables([], TorchMeshSampler(), 'cpu') is None
    with pytest.raises(ValueError, match='layout'):
        tds.build_device_tables([], TorchMeshSampler(), 'cpu',
                                layout='ragged')
    with pytest.raises(TypeError, match='device'):  # no default device
        tds.build_device_tables([], TorchMeshSampler())


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------


def _ragged_dense():
    """The synthetic ragged dense table of test_device_sampler.py::
    test_kernel_matches_oracle_ragged_tables: face counts below, at and
    above the 128 lane width, alias indices up to nf - 1."""
    rng = np.random.default_rng(0)
    n_pieces, fmax = 3, 256
    table = np.zeros((n_pieces, 16, fmax), np.float32)
    nf = np.array([200, 37, 256], np.int32)
    for i in range(n_pieces):
        table[i, 0:9, :nf[i]] = rng.normal(size=(9, nf[i]))
        table[i, dsmp._ROW_PROB, :nf[i]] = rng.uniform(size=nf[i])
        table[i, dsmp._ROW_PROB, nf[i]:] = 1.0
        table[i, dsmp._ROW_ALIAS, :nf[i]] = \
            rng.integers(0, nf[i], nf[i]).astype(np.float32)
        table[i, dsmp._ROW_ALIAS, nf[i]:] = np.arange(nf[i], fmax)
    return table, nf


@pytest.mark.parametrize('case', ['dense-cubes', 'dense-ragged',
                                  'chunked-cubes', 'chunked-soups'])
def test_plain_sampler_matches_jax(meshes, case):
    layout, mesh_set = case.split('-')
    if mesh_set == 'ragged':
        table, nf = _ragged_dense()
        n_pieces = 3
    else:
        ref = dsmp.build_device_tables(
            meshes[mesh_set], MeshSampler(), layout=layout,
            chunk_f=128 if mesh_set == 'soups' else 512)
        table, nf = np.asarray(ref.table), np.asarray(ref.n_faces)
        n_pieces = len(meshes[mesh_set])
    K, n = 7, 200
    slots = np.random.default_rng(3).integers(0, n_pieces, K).astype(
        np.int32)
    u = _uniforms(K, 256, seed=4)
    j_args = (jnp.asarray(table), jnp.asarray(nf), jnp.asarray(slots),
              jnp.asarray(u), n)
    j_ref = np.asarray(dsmp.sample_packed_ref(*j_args))
    j_ker = np.asarray(dsmp._sample_points(*j_args, interpret=True))

    pts, draws = tds._sample_points(
        torch.tensor(table), torch.tensor(nf), torch.tensor(slots),
        torch.tensor(u[:, :3, :n]), return_draws=True)
    assert pts.shape == (K, n, 3) and pts.dtype == torch.float32
    np.testing.assert_allclose(pts.numpy(), j_ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(pts.numpy(), j_ker, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        draws.numpy(), _np_draws(table, nf, slots, u[:, 0, :n]))


def test_chunked_matches_dense_bitwise(meshes):
    """Chunked tables (Fc = 128) draw bit-identical points to the dense
    layout on pieces of 300 (3 chunks, ragged last), 128 (exactly one), 37
    (sub-chunk) and 520 (5 chunks) faces; a chunked draw that took the
    alias triangle names the same face as the dense draw's alias."""
    s = TorchMeshSampler()
    dense = tds.build_device_tables(meshes['soups'], s, 'cpu',
                                    layout='dense')
    chunk = tds.build_device_tables(meshes['soups'], s, 'cpu',
                                    layout='chunked', chunk_f=128)
    assert chunk.table.shape[0] == 10  # 3 + 1 + 1 + 5 chunks
    assert tuple(chunk.n_faces.shape) == (3 + 5, 4)
    slots = torch.tensor([0, 3, 1, 2, 3, 0], dtype=torch.int32)
    u = torch.tensor(_uniforms(6, 2048, seed=7)[:, :3, :2000])
    pd, fd = tds._sample_points(dense.table, dense.n_faces, slots, u,
                                return_draws=True)
    pc, fc = tds._sample_points(chunk.table, chunk.n_faces, slots, u,
                                return_draws=True)
    assert torch.equal(pd, pc)
    taken = (fc < 0).nonzero(as_tuple=True)
    assert 0 < len(taken[0]) < fc.numel()  # both branches drawn
    alias = tds.jax_table(dense.table)[
        slots.long()[:, None], tds._ROW_ALIAS,
        torch.where(fc < 0, -1 - fc, fc).long()]
    expect = torch.where(fc < 0, (alias + 0.5).to(torch.int32), fc)
    assert torch.equal(fd, expect)


@pytest.mark.parametrize('chunk_f', [512, 128])
@pytest.mark.parametrize('mesh_set', ['cubes', 'soups'])
def test_records_match_jax_columns(meshes, mesh_set, chunk_f):
    """Every face's record, found as the kernel finds it (record base * Fc
    + f of the piece whose chunks start at row base), holds the JAX chunked
    table's column of that face: triangle, prob, alias triangle, then zero
    padding."""
    ours, ref = _both_tables(meshes[mesh_set], layout='chunked',
                             chunk_f=chunk_f)
    table, meta = np.asarray(ref.table), np.asarray(ref.n_faces)
    records = tds.table_records(ours.table).numpy()
    assert records.shape == (table.shape[0], chunk_f, tds._N_ROWS_C)
    flat = records.reshape(-1, tds._N_ROWS_C)
    for slot in range(meta.shape[1]):
        base, nch = meta[dsmp._META_BASE, slot], meta[dsmp._META_NCH, slot]
        faces = np.arange(nch * chunk_f)
        got = flat[base * chunk_f + faces]                   # [F, 24]
        want = table[base + faces // chunk_f, :, faces % chunk_f]
        for rows in (slice(dsmp._CROW_TRI, dsmp._CROW_TRI + 9),
                     slice(dsmp._CROW_PROB, dsmp._CROW_PROB + 1),
                     slice(dsmp._CROW_ATRI, dsmp._CROW_ATRI + 9)):
            np.testing.assert_array_equal(got[:, rows], want[:, rows])
        assert not got[:, dsmp._CROW_ATRI + 9:].any()


@pytest.mark.parametrize('return_draws', [False, True])
@pytest.mark.parametrize('mesh_set', ['cubes', 'soups'])
def test_records_sampler_matches_chunked_and_jax(meshes, mesh_set,
                                                 return_draws):
    """The plain version of the chunked kernel (`sample_records_plain`, on
    the records) equals `sample_chunked_plain` (on the table) bit for bit,
    and the JAX chunked reference on the same uniforms; `_sample_points`
    takes it on a chunked table."""
    chunk_f = 128 if mesh_set == 'soups' else 512
    ours, ref = _both_tables(meshes[mesh_set], layout='chunked',
                             chunk_f=chunk_f)
    K, n = 9, 300
    slots = np.random.default_rng(5).integers(
        0, len(meshes[mesh_set]), K).astype(np.int32)
    u = _uniforms(K, 384, seed=6)
    args = (ours.n_faces, torch.tensor(slots), torch.tensor(u[:, :3, :n]))
    got = tds.sample_records_plain(tds.table_records(ours.table), *args,
                                   return_draws=return_draws)
    want = tds.sample_chunked_plain(ours.table, *args,
                                    return_draws=return_draws)
    via = tds._sample_points(ours.table, *args, return_draws=return_draws)
    if return_draws:
        (got, draws), (want, want_draws), (via, via_draws) = got, want, via
        np.testing.assert_array_equal(draws.numpy(), want_draws.numpy())
        np.testing.assert_array_equal(draws.numpy(), via_draws.numpy())
        np.testing.assert_array_equal(
            draws.numpy(), _np_draws(np.asarray(ref.table),
                                     np.asarray(ref.n_faces), slots,
                                     u[:, 0, :n]))
    assert torch.equal(got, want) and torch.equal(got, via)
    j_ref = np.asarray(dsmp.sample_packed_ref(
        ref.table, ref.n_faces, jnp.asarray(slots), jnp.asarray(u), n))
    np.testing.assert_array_equal(got.numpy(), j_ref)


@pytest.mark.parametrize('mesh_set', ['cubes', 'soups'])
def test_dense_records_match_jax_table(meshes, mesh_set):
    """Every face's 48-byte dense record, found as the kernel finds it
    (record s * Fmax + f of slot s), holds rows 0-10 of the JAX dense
    table's column of that face (triangle, prob, alias), then one zero;
    `jax_table` gives the JAX table back, array for array."""
    ours, ref = _both_tables(meshes[mesh_set], layout='dense')
    table = np.asarray(ref.table)
    records = tds.table_records(ours.table)
    assert records is ours.table and records.is_contiguous()
    assert records.shape == (table.shape[0], table.shape[2], 3, 4)
    flat = records.numpy().reshape(-1, 12)
    for slot in range(table.shape[0]):
        got = flat[slot * table.shape[2] + np.arange(table.shape[2])]
        np.testing.assert_array_equal(got[:, :dsmp._ROW_ALIAS + 1],
                                      table[slot, :dsmp._ROW_ALIAS + 1].T)
        assert not got[:, dsmp._ROW_ALIAS + 1:].any()
    assert not table[:, dsmp._ROW_ALIAS + 1:].any()
    np.testing.assert_array_equal(tds.jax_table(records).numpy(), table)


@pytest.mark.parametrize('return_draws', [False, True])
@pytest.mark.parametrize('mesh_set', ['cubes', 'soups'])
def test_dense_records_sampler_matches_table_and_jax(meshes, mesh_set,
                                                     return_draws):
    """The plain version of the dense kernel (`sample_dense_records_plain`,
    on the records) equals `sample_dense_plain` (on the table) bit for bit,
    and the JAX `sample_packed_ref` on the same uniforms; `_sample_points`
    takes it on a dense table."""
    ours, ref = _both_tables(meshes[mesh_set], layout='dense')
    K, n = 9, 300
    slots = np.random.default_rng(8).integers(
        0, len(meshes[mesh_set]), K).astype(np.int32)
    u = _uniforms(K, 384, seed=9)
    args = (ours.n_faces, torch.tensor(slots), torch.tensor(u[:, :3, :n]))
    got = tds.sample_dense_records_plain(ours.table, *args,
                                         return_draws=return_draws)
    want = tds.sample_dense_plain(tds.jax_table(ours.table), *args,
                                  return_draws=return_draws)
    via = tds._sample_points(ours.table, *args, return_draws=return_draws)
    if return_draws:
        (got, draws), (want, want_draws), (via, via_draws) = got, want, via
        np.testing.assert_array_equal(draws.numpy(), want_draws.numpy())
        np.testing.assert_array_equal(draws.numpy(), via_draws.numpy())
        np.testing.assert_array_equal(
            draws.numpy(), _np_draws(np.asarray(ref.table),
                                     np.asarray(ref.n_faces), slots,
                                     u[:, 0, :n]))
    assert torch.equal(got, want) and torch.equal(got, via)
    j_ref = np.asarray(dsmp.sample_packed_ref(
        ref.table, ref.n_faces, jnp.asarray(slots), jnp.asarray(u), n))
    np.testing.assert_array_equal(got.numpy(), j_ref)


def test_dense_kernel_takes_records():
    """The dense kernel's wrapper takes the records ([*, Fmax, 3, 4]) and
    refuses a CPU tensor; a dense table off the CPU, records or the JAX
    layout, goes to the kernel, which refuses what is not a CUDA tensor,
    rather than taking another path."""
    records = torch.zeros((2, 8, 3, 4))
    n_faces = torch.full((2, ), 8, dtype=torch.int32)
    slots = torch.zeros(1, dtype=torch.int32)
    u = torch.zeros((1, 3, 4))
    with pytest.raises(ValueError, match='records: expected a CUDA tensor'):
        tds.sample_dense_cuda(records, n_faces, slots, u)
    for table in (torch.zeros((2, 8, 3, 4), device='meta'),
                  torch.zeros((2, tds._N_ROWS, 8), device='meta')):
        with pytest.raises(ValueError,
                           match='records: expected a CUDA tensor'):
            tds._sample_points(table, n_faces, slots, u)


def test_chunked_kernel_takes_records():
    """The chunked kernel's wrapper takes the records ([*, Fc, 24]) and
    refuses a CPU tensor; a chunked table off the CPU goes to the kernel
    through its records, which refuses what is not a CUDA tensor, rather
    than taking another path."""
    records = torch.zeros((2, 8, tds._N_ROWS_C))
    meta = torch.zeros((4, 1), dtype=torch.int32)
    slots = torch.zeros(1, dtype=torch.int32)
    u = torch.zeros((1, 3, 4))
    with pytest.raises(ValueError, match='records: expected a CUDA tensor'):
        tds.sample_chunked_cuda(records, meta, slots, u)
    with pytest.raises(ValueError, match='records: expected a CUDA tensor'):
        tds._sample_points(torch.zeros((2, tds._N_ROWS_C, 8), device='meta'),
                           meta, slots, u)


def test_sample_and_expand_is_seeded(meshes):
    tables = tds.build_device_tables(meshes['cubes'], TorchMeshSampler(),
                                     'cpu')
    slots = torch.tensor([0, 1, 2, 2, 0], dtype=torch.int32)
    counts = torch.tensor([2, 3], dtype=torch.int32)

    def run(seed):
        return tds.sample_and_expand(tables.table, tables.n_faces, slots,
                                     counts, seed, n_points=64, max_parts=4,
                                     data_keys=KEYS)

    a, b, c = run(5), run(5), run(6)
    assert a['part_pcs_raw'].shape == (2, 4, 64, 3)
    assert torch.equal(a['part_pcs_raw'], b['part_pcs_raw'])
    assert not torch.equal(a['part_pcs_raw'], c['part_pcs_raw'])
    assert torch.equal(a['part_valids'].sum(1), torch.tensor([2.0, 3.0]))


# ---------------------------------------------------------------------------
# expansion and the slot collate
# ---------------------------------------------------------------------------


def test_expand_matches_jax():
    rng = np.random.default_rng(0)
    counts = np.asarray([3, 1, 4], np.int32)
    packed = rng.normal(size=(int(counts.sum()), 16, 3)).astype(np.float32)
    ref = jgeo.expand_geometry_batch(jnp.asarray(packed),
                                     jnp.asarray(counts), max_parts=5,
                                     data_keys=KEYS)
    ours = tgeo.expand_geometry_batch(torch.tensor(packed),
                                      torch.tensor(counts), max_parts=5,
                                      data_keys=KEYS)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32, k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v),
                                      err_msg=k)


def _datasets(root, **kw):
    kw = dict(data_dir=root, data_fn='everyday.train.txt', data_keys=KEYS,
              num_points=N, max_num_part=P, **kw)
    ours, ref = tgeo.GeometryPartDataset(**kw), JaxDataset(**kw)
    ours._device_tables = tds.build_device_tables(ours.all_mesh_paths(),
                                                  ours.sampler, 'cpu')
    ref._device_tables = dsmp.build_device_tables(ref.all_mesh_paths(),
                                                  ref.sampler)
    return ours, ref


@pytest.mark.parametrize('epoch,indices', [(0, [0, 1, 2]), (3, [2, 0]),
                                           (7, [1])])
def test_slot_collate_matches_jax(bb_tree, epoch, indices):
    ours, ref = _datasets(bb_tree)
    assert ours.all_mesh_paths() == ref.all_mesh_paths()
    ours.set_epoch(epoch)
    ref.set_epoch(epoch)
    a, b = ours.collate_batch(indices), ref.collate_batch(indices)
    K = int(a['part_counts'].sum())
    assert a['part_slots__packed'].shape == (K, )
    np.testing.assert_array_equal(a['part_slots__packed'],
                                  b['part_slots__packed'][:K])
    assert not b['part_slots__packed'][K:].any()  # JAX's Kpad padding
    np.testing.assert_array_equal(a['part_counts'], b['part_counts'])
    assert a['sample_seed'] == b['sample_seed']
    assert a['sample_seed'].dtype == np.int32
    np.testing.assert_array_equal(a['data_id'], b['data_id'])
    assert a['__tables__'] is ours._device_tables


def test_loader_ships_the_slot_wire(bb_tree):
    ours, _ = _datasets(bb_tree)
    batch = next(iter(tgeo.DataLoader(ours, batch_size=3)))
    assert set(batch) == {'part_slots__packed', 'part_counts',
                          'sample_seed', '__tables__', 'data_id'}
    assert batch['part_slots__packed'].dtype == torch.int32
    assert batch['part_slots__packed'].numel() == 2 + 3 + 5
    assert batch['__tables__'] is ours._device_tables


# ---------------------------------------------------------------------------
# the slice: sampled, expanded, augmented, one MoN step
# ---------------------------------------------------------------------------


def test_sampled_step_matches_jax(no_dropout_f32, bb_tree):  # noqa: F811
    """The JAX pipeline (interpret-mode kernel, expand, augment, MoN loss
    and gradients) against the port's (plain sampler, expand, augment with
    the JAX rotations injected, MoN loss and gradients) on the same slots,
    uniforms and converted weights."""
    ours_ds, ref_ds = _datasets(bb_tree)
    assert len(ours_ds) == B
    indices = list(range(B))
    a, b = ours_ds.collate_batch(indices), ref_ds.collate_batch(indices)
    K = len(a['part_slots__packed'])
    u = _uniforms(len(b['part_slots__packed']), 128, seed=11)

    tab = ref_ds._device_tables
    packed = dsmp._sample_points(tab.table, tab.n_faces,
                                 jnp.asarray(b['part_slots__packed']),
                                 jnp.asarray(u), N, interpret=True)
    jb = jgeo.expand_geometry_batch(packed, jnp.asarray(b['part_counts']),
                                    max_parts=P, data_keys=KEYS)
    raw, valids = np.asarray(jb['part_pcs_raw']), np.asarray(
        jb['part_valids'])
    ref = _jax_step(raw, valids)

    tt = ours_ds._device_tables
    ours_packed = tds._sample_points(
        tt.table, tt.n_faces, torch.tensor(a['part_slots__packed']),
        torch.tensor(u[:K, :3, :N]))
    tb = tgeo.expand_geometry_batch(ours_packed,
                                    torch.tensor(a['part_counts']),
                                    max_parts=P, data_keys=KEYS)
    np.testing.assert_allclose(tb['part_pcs_raw'].numpy(), raw, atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(tb['part_valids'].numpy(), valids)
    ours = _torch_step(tb['part_pcs_raw'].numpy(),
                       tb['part_valids'].numpy(), ref)

    for k in ('part_pcs', 'part_quat', 'part_trans'):
        np.testing.assert_allclose(ours['aug'][k].numpy(), ref['aug'][k],
                                   atol=1e-5, rtol=0)
    assert set(ours['logs']) == set(ref['logs'])
    for k, v in ref['logs'].items():
        np.testing.assert_allclose(float(ours['logs'][k].detach()), v,
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    ref_grads = jax_to_state_dict({'params': ref['grads'],
                                   'batch_stats': ref['var']['batch_stats']})
    for name, g in ours['grads'].items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize('layout', ['dense', 'chunked'])
def test_train_script_device_sampling_on_cpu(synth, tmp_path,  # noqa: F811
                                             layout):
    """scripts/train_torch.py end to end at a tiny size on the CPU through
    the slot wire, in each table layout."""
    import train_torch
    trainer = train_torch.main([
        '--cfg_file', FLAGSHIP, '--ckp_dir', str(tmp_path / 'run'),
        '--device', 'cpu', '--no-bf16', '--opts', 'data.data_dir', synth,
        'exp.batch_size', '2', 'exp.num_epochs', '1', 'exp.val_every', '1',
        *OPTS[:8], 'data.num_pc_points', '16', 'data.device_sampling',
        'True', 'data.device_table_layout', layout])
    for split in ('train', 'val'):
        assert trainer.tables[split].layout == layout
        assert trainer.tables[split].table.device.type == 'cpu'
    assert trainer.step == 3
    assert 0.0 <= trainer.metrics['val/part_acc'] <= 1.0
    assert all(np.isfinite(v) for v in trainer.metrics.values())


# ---------------------------------------------------------------------------
# the repairs: explicit device, reading data.device_sampling
# ---------------------------------------------------------------------------


def test_absent_cuda_raises(monkeypatch, tmp_path):
    """The CLI trains on CUDA by default and raises when it is absent,
    rather than running on the CPU."""
    import train_torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert train_torch.parse_args(['--cfg_file', FLAGSHIP]).device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_torch.main(['--cfg_file', FLAGSHIP, '--ckp_dir',
                          str(tmp_path / 'run')])
    assert not (tmp_path / 'run').exists()


def _cfg(dataset='geometry', **data):
    return TCFG.CN({'data': {'dataset': dataset, **data}})


CUDA, CPU = torch.device('cuda'), torch.device('cpu')


@pytest.mark.parametrize('value,device,dataset,expected', [
    (True, CPU, 'geometry', True),
    (False, CUDA, 'geometry', False),
    ('auto', CUDA, 'geometry', True),
    ('auto', CPU, 'geometry', False),
    ('auto', CUDA, 'partnet', False),
    (None, CUDA, 'geometry', True),      # key absent: 'auto'
    ('True', CPU, 'geometry', True),
    ('false', CUDA, 'geometry', False),
    ('False', CUDA, 'geometry', False),  # the JAX trainer reads this as on
    ('AUTO', CPU, 'geometry', False),
    ('Auto', CUDA, 'geometry', True),
])
def test_device_sampling_reading(value, device, dataset, expected):
    cfg = _cfg(dataset) if value is None else \
        _cfg(dataset, device_sampling=value)
    assert ttrainer.device_sampling_enabled(cfg, device) is expected


@pytest.mark.parametrize('value', ['yes', 'off', '', 1, 0, 0.0])
def test_device_sampling_other_values_raise(value):
    with pytest.raises(ValueError, match='device_sampling'):
        ttrainer.device_sampling_enabled(_cfg(device_sampling=value), CPU)


def test_opts_false_reads_as_off():
    """`--opts data.device_sampling False` keeps the string 'False' (the
    key is absent from the configs); the port reads it as off."""
    cfg = TCFG.load_cfg_file(FLAGSHIP).merge_from_list(
        ['data.device_sampling', 'False'])
    assert cfg.data.device_sampling == 'False'
    assert ttrainer.device_sampling_enabled(cfg, CUDA) is False
