"""Device-side mesh surface sampling: the slot wire's sampler on the card.

Port of multi_part_assembly_tpu/datasets/device_sampler.py.  Every mesh
piece's triangle table and Walker alias table is packed once into a
resident table on the device; per batch the host ships only which piece
each packed part row is (`part_slots__packed`), the per-sample part counts
and one seed, and the card draws the surface points itself.

Table layouts are the JAX package's, array for array (the tests compare
them):

  * DENSE `[n_pieces, 16, Fmax]` f32: rows 0-8 the triangles (a, b-a, c-a,
    component-major), row 9 the alias acceptance threshold, row 10 the
    alias face index (an exact f32 integer); `n_faces` is `[n_pieces]` i32.
  * CHUNKED `[total_chunks, 24, Fc]` f32: each piece split into
    ceil(F / Fc) chunks; rows 0-8 the triangle of face f, row 9 prob, rows
    10-18 the triangle of alias(f), so a draw needs only f0's own column;
    `n_faces` is then the `[3 + Cmax, n_pieces]` i32 meta array (face
    count, first chunk row, chunk count).

The port stores either table face-major, as RECORDS, one a face, which
its kernel reads; `table_records(table)` gives them.  Dense:
`DeviceTables.table` is the records themselves, `[n_pieces, Fmax, 3, 4]`,
face f of slot s the 48-byte record `s * Fmax + f` (triangle, prob, alias,
one float of padding): 48 bytes a face move fewer bytes than 64 when most
faces of a piece are drawn, and no view of them has the JAX layout, so
`jax_table(table)` makes that layout (a copy, for the tests and the
checks).  Chunked: `DeviceTables.table` is the view
`records.permute(0, 2, 1)` of the records `[total_chunks, Fc, 24]`, so it
holds the JAX values with no second copy; face f0 of a piece is the
96-byte record `base * Fc + f0` (triangle, prob, alias triangle, zero
padding).

Kernels B5 (`sample_dense_cuda`) and B6 (`sample_chunked_cuda`) are CUDA
C++ in csrc/device_sampler.cu, and both read the records.  Beside each sits
its plain PyTorch version on the same inputs (`sample_dense_records_plain`,
`sample_records_plain`), computing the same draw in the same order of
rounded operations; `sample_dense_plain` and `sample_chunked_plain` are the
same draws read from the tables' JAX layout, the references.  A CPU tensor
takes the plain version, since no kernel exists for the CPU; a CUDA tensor
launches the kernel or raises.  `LAUNCHES` counts the kernel launches.

The uniforms are `[K, 3, N]` f32 (rows 0-2 of the JAX package's
`[K, 8, Npad]`: face draw, sqrt argument, barycentric mix), drawn with
`torch.rand` from a generator seeded by the batch's `sample_seed`.  The
stream differs from the JAX package's threefry stream by design; the tests
inject the same uniforms into both.
"""

import numpy as np
import torch

from .geometry import expand_geometry_batch
from ..ops.cuda_build import load_library

__all__ = ['DeviceTables', 'build_device_tables', 'table_records',
           'jax_table', 'sample_packed', 'sample_packed_ref',
           'sample_and_expand', 'sample_dense_cuda', 'sample_chunked_cuda',
           'sample_dense_plain', 'sample_dense_records_plain',
           'sample_chunked_plain', 'sample_records_plain', 'LAUNCHES',
           'reset_launches']

# dense table row layout (per piece, [16, Fmax] f32), and the values of a
# dense record ([3, 4] f32 a face: the rows 0-10, one float of padding)
_ROW_TRI = 0      # rows 0-8: a.xyz, (b-a).xyz, (c-a).xyz, component-major
_ROW_PROB = 9     # alias acceptance threshold
_ROW_ALIAS = 10   # alias face index (f32-encoded, exact below 2^24)
_N_ROWS = 16
_REC_D = (3, 4)   # a dense record: 12 floats, three float4

# chunked table row layout (per chunk, [24, Fc] f32)
_CROW_TRI = 0     # rows 0-8: tri(f), same component-major layout
_CROW_PROB = 9    # alias acceptance threshold
_CROW_ATRI = 10   # rows 10-18: tri(alias(f)); rows 19-23 padding
_N_ROWS_C = 24
_CHUNK_F = 512    # default chunk width (faces)

# chunked meta rows ([3 + Cmax, n_pieces] i32; rows 3+ are zero padding
# that carry Cmax in the shape, as in the JAX package)
_META_NF = 0      # face count
_META_BASE = 1    # first chunk row in the table
_META_NCH = 2     # chunk count (= ceil(nf / Fc))

# sampling stream domain separator (JAX device_sampler.py:461)
_BASE_KEY = 0x5e1ec7ab

LAUNCHES = {'sample_dense': 0, 'sample_chunked': 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(x, m):
    return -(-x // m) * m


class DeviceTables:
    """Device-resident sampling tables and the host path -> slot map."""

    def __init__(self, table, n_faces, slot_of, fmax):
        # dense: table the records [n_pieces, Fmax, 3, 4], n_faces
        # [n_pieces] i32; chunked: table [total_chunks, 24, Fc], the view
        # of its records, n_faces the [3 + Cmax, n_pieces] i32 meta array
        self.table = table
        self.n_faces = n_faces
        self.slot_of = slot_of  # mesh path -> slot
        self.fmax = fmax        # dense Fmax / chunked Fc

    @property
    def layout(self):
        return 'dense' if self.table.dim() == 4 else 'chunked'

    @property
    def nbytes(self):
        return self.table.numel() * 4 + self.n_faces.numel() * 4


def table_records(table):
    """The records a table's kernel reads, from the table as DeviceTables
    holds it: the dense records [n_pieces, Fmax, 3, 4] as they are, or the
    chunked table [total_chunks, 24, Fc] as its records [total_chunks, Fc,
    24] (a view; the view is its own inverse).  Dense record `s * Fmax + f`
    holds face f of slot s: the triangle (0-8), prob (9) and alias (10),
    then one float of padding, 48 bytes.  Chunked record `base * Fc + f` of
    a piece whose chunks start at row `base` holds face f's column: the
    triangle (0-8), prob (9) and the alias triangle (10-18), then zero
    padding, 96 bytes.  The records of the tables that
    `build_device_tables` makes are contiguous."""
    return table if table.dim() == 4 else table.permute(0, 2, 1)


def jax_table(table):
    """The JAX layout of a table as DeviceTables holds it: the dense
    [n_pieces, 16, Fmax] table of the dense records (a copy, rows 11-15
    zero), or the chunked table as it is."""
    if table.dim() != 4:
        return table
    n, fmax = table.shape[:2]
    out = table.new_zeros((n, _N_ROWS, fmax))
    out[:, :_ROW_ALIAS + 1] = \
        table.reshape(n, fmax, -1)[..., :_ROW_ALIAS + 1].permute(0, 2, 1)
    return out


def build_device_tables(paths, sampler, device, budget_bytes=4 * 1024 ** 3,
                        fmax=None, chunk_f=_CHUNK_F, layout=None):
    """Assemble the sampling tables for `paths` in numpy and place them on
    `device`, which the caller names (JAX device_sampler.py:122-209).

    `sampler` is a mesh_io.MeshSampler.  `layout` picks the table format:
    'dense', 'chunked', or None = auto: the JAX package's rule, kept
    verbatim, which picks the layout whose TPU kernel scans fewer one-hot
    columns per row (dense 2 x Fmax, chunked mean_chunks x Fc) among those
    that fit `budget_bytes`, else None (the caller keeps the host wire).
    On the card a draw is a direct gather in either layout, so the rule's
    cost model is the TPU's; PERF.md holds both kernels' card times."""
    if layout not in (None, 'dense', 'chunked'):
        raise ValueError(f"layout: expected 'dense', 'chunked' or None, "
                         f'got {layout!r}')
    paths = list(dict.fromkeys(paths))  # stable unique order
    if not paths:
        return None
    counts = [sampler.n_faces(p) for p in paths]
    n_pieces = len(paths)
    slot_of = {p: i for i, p in enumerate(paths)}

    def put(a):
        return torch.from_numpy(a).to(device)

    if layout is None:
        fmax_a = fmax if fmax is not None else \
            max(128, _round_up(max(counts), 128))
        dense_fits = max(counts) <= fmax_a and \
            n_pieces * _N_ROWS * fmax_a * 4 <= budget_bytes
        nch_a = [max(1, -(-f // chunk_f)) for f in counts]
        chunk_fits = sum(nch_a) * _N_ROWS_C * chunk_f * 4 <= budget_bytes
        dense_cols = 2 * fmax_a                          # two matmuls/row
        chunk_cols = sum(nch_a) / n_pieces * chunk_f     # one per chunk
        if dense_fits and (not chunk_fits or dense_cols <= chunk_cols):
            layout = 'dense'
        elif chunk_fits:
            layout = 'chunked'
        else:
            return None

    if layout == 'dense':
        fmax_d = fmax if fmax is not None else \
            max(128, _round_up(max(counts), 128))
        if max(counts) <= fmax_d and \
                n_pieces * _N_ROWS * fmax_d * 4 <= budget_bytes:
            # face-major: face f of slot i is record i * fmax_d + f
            records = np.zeros((n_pieces, fmax_d, _REC_D[0] * _REC_D[1]),
                               np.float32)
            for i, p in enumerate(paths):
                tri9, prob, alias, _ = sampler.export_tables(p, fmax_d)
                records[i, :, _ROW_TRI:_ROW_TRI + 9] = tri9.T
                records[i, :, _ROW_PROB] = prob
                records[i, :, _ROW_ALIAS] = alias
            return DeviceTables(
                put(records.reshape(n_pieces, fmax_d, *_REC_D)),
                put(np.asarray(counts, np.int32)), slot_of, fmax_d)
        return None

    # chunked: memory ~ sum(ceil(F_i / chunk_f)) * 24 * chunk_f
    nch = [max(1, -(-f // chunk_f)) for f in counts]
    total = sum(nch)
    if total * _N_ROWS_C * chunk_f * 4 > budget_bytes:
        return None
    cmax = max(nch)
    base = np.zeros(n_pieces, np.int64)
    base[1:] = np.cumsum(nch)[:-1]
    meta = np.zeros((3 + cmax, n_pieces), np.int32)
    meta[_META_NF] = counts
    meta[_META_BASE] = base
    meta[_META_NCH] = nch
    # face-major: a piece's chunks are consecutive, so its faces are
    # consecutive records from base * chunk_f on
    records = np.zeros((total * chunk_f, _N_ROWS_C), np.float32)
    for i, p in enumerate(paths):
        fpad = nch[i] * chunk_f
        tri9, prob, alias, _ = sampler.export_tables(p, fpad)
        # alias indices are exact f32 integers (padding aliases itself,
        # inside fpad); +0.5 guards the cast like the kernels' round
        atri = tri9[:, (alias + 0.5).astype(np.int64)]
        rec = records[base[i] * chunk_f:base[i] * chunk_f + fpad]
        rec[:, _CROW_TRI:_CROW_TRI + 9] = tri9.T
        rec[:, _CROW_PROB] = prob
        rec[:, _CROW_ATRI:_CROW_ATRI + 9] = atri.T
    records = put(records.reshape(total, chunk_f, _N_ROWS_C))
    return DeviceTables(records.permute(0, 2, 1), put(meta), slot_of,
                        chunk_f)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _require(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f'{name}: expected a tensor on {device}, got '
                         f'{t.device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')


def _launch(fn_name, table, name, shape, width, index, slots, uniforms,
            n_pieces, return_draws):
    """Checks, output allocation and one launch of a sampling kernel on
    `table` (named `name`, of `shape`, -1 for any extent) whose face axis
    has `width` entries."""
    device = table.device
    if device.type != 'cuda':
        raise ValueError(f'{name}: expected a CUDA tensor, got {device}')
    if table.dim() != len(shape) or any(
            s not in (-1, t) for s, t in zip(shape, table.shape)):
        raise ValueError(f'{name}: expected shape {list(shape)}, got '
                         f'{tuple(table.shape)}')
    _require(table, name, torch.float32, table.shape, device)
    _require(index, 'n_faces', torch.int32, index.shape, device)
    K = slots.shape[0]
    N = uniforms.shape[-1]
    _require(slots, 'slots', torch.int32, (K, ), device)
    _require(uniforms, 'uniforms', torch.float32, (K, 3, N), device)
    out = torch.empty((K, N, 3), dtype=torch.float32, device=device)
    draws = torch.empty((K, N), dtype=torch.int32, device=device) \
        if return_draws else None
    lib = load_library()
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(
            table.data_ptr(), index.data_ptr(), slots.data_ptr(),
            uniforms.data_ptr(), out.data_ptr(),
            None if draws is None else draws.data_ptr(), K, N, width,
            n_pieces, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'{fn_name}: CUDA error {rc}')
    return out, draws


def sample_dense_cuda(records, n_faces, slots, uniforms, return_draws=False):
    """Kernel B5: area-weighted surface points from the dense table's
    48-byte records, f0's prob and alias first, then the drawn triangle.

    Replaces `_sample_kernel` (JAX device_sampler.py:212), launched by
    `_sample_points` (:357).

    Args:
        records: [n_pieces, Fmax, 3, 4] f32 CUDA, contiguous: the dense
            table's records;  n_faces: [n_pieces] int32
        slots: [K] int32 piece slot of each packed row, in [0, n_pieces)
            (a slot outside gives NaN points)
        uniforms: [K, 3, N] f32

    Returns:
        points [K, N, 3] f32, and with `return_draws` the sampled face of
        each point, [K, N] int32
    """
    out, draws = _launch('mpa_sample_dense', records, 'records',
                         (-1, -1, *_REC_D), records.shape[1], n_faces, slots,
                         uniforms, n_faces.shape[0], return_draws)
    LAUNCHES['sample_dense'] += 1
    return (out, draws) if return_draws else out


def sample_chunked_cuda(records, meta, slots, uniforms, return_draws=False):
    """Kernel B6: the same draw from the chunked layout, one 96-byte record
    read whole in f0's chunk (no chunk loop).

    Replaces `_sample_kernel_chunked` (JAX device_sampler.py:269), launched
    by `_sample_points_chunked` (:319).

    Args:
        records: [total_chunks, Fc, 24] f32 CUDA, contiguous: the chunked
            table's records (`table_records`);  meta: [3 + Cmax,
            n_pieces] int32;  slots, uniforms: as `sample_dense_cuda`

    Returns:
        points [K, N, 3] f32, and with `return_draws` the draw of each
        point, [K, N] int32: f0 where the alias test kept it, -1 - f0 where
        the alias triangle was taken
    """
    if meta.dim() != 2 or meta.shape[0] < 3:
        raise ValueError(f'meta: expected shape [3 + Cmax, n_pieces], got '
                         f'{tuple(meta.shape)}')
    out, draws = _launch('mpa_sample_chunked', records, 'records',
                         (-1, -1, _N_ROWS_C), records.shape[1], meta, slots,
                         uniforms, meta.shape[1], return_draws)
    LAUNCHES['sample_chunked'] += 1
    return (out, draws) if return_draws else out


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _draw_face(u0, F):
    """f0 = min(floor(u0 * F), F - 1) and its remainder; u0 [K, N], F [K]."""
    F = F.to(torch.float32)[:, None]
    rf = u0 * F
    f0 = torch.minimum(torch.floor(rf), F - 1.0)
    return f0.long(), rf - f0


def _mix(tri, uniforms):
    """(a + b1 e1) + b2 e2 from tri [K, N, 9] and uniforms [K, 3, N].  The
    square root is taken in f64 and rounded once to f32, which is correctly
    rounded, as the kernels' __fsqrt_rn and JAX's sqrt are (the CPU's f32
    torch.sqrt is not, for a few inputs)."""
    su = torch.sqrt(uniforms[:, 1].double()).float()
    b1 = (su * (1.0 - uniforms[:, 2]))[..., None]
    b2 = (su * uniforms[:, 2])[..., None]
    return tri[..., 0:3] + b1 * tri[..., 3:6] + b2 * tri[..., 6:9]


def sample_dense_plain(table, n_faces, slots, uniforms, return_draws=False):
    """The draw of `sample_dense_cuda` read from the dense table's JAX
    layout (JAX `sample_packed_ref`, device_sampler.py:434-458), by flat
    gathers: the reference for `sample_dense_records_plain`."""
    fmax = table.shape[2]
    flat = table.reshape(-1)
    sl = slots.long()
    f0, frac = _draw_face(uniforms[:, 0], n_faces[sl])
    piece = (sl * _N_ROWS)[:, None]                          # [K, 1]
    prob = flat[(piece + _ROW_PROB) * fmax + f0]
    alias = flat[(piece + _ROW_ALIAS) * fmax + f0]
    # +0.5 before the truncating cast rounds the exact-integer alias
    f = torch.where(frac < prob, f0, (alias + 0.5).long())   # [K, N]
    rows = piece[..., None] + torch.arange(9, device=table.device)
    tri = flat[(rows + _ROW_TRI) * fmax + f[..., None]]      # [K, N, 9]
    out = _mix(tri, uniforms)
    return (out, f.to(torch.int32)) if return_draws else out


def sample_dense_records_plain(records, n_faces, slots, uniforms,
                               return_draws=False):
    """Plain version of `sample_dense_cuda`, on its inputs: the draw of
    `sample_dense_plain` read from the face-major records, by flat
    gathers."""
    fmax = records.shape[1]
    width = _REC_D[0] * _REC_D[1]
    flat = records.reshape(-1)
    sl = slots.long()
    f0, frac = _draw_face(uniforms[:, 0], n_faces[sl])
    piece = (sl * fmax)[:, None]                             # [K, 1]
    rec = (piece + f0) * width
    prob = flat[rec + _ROW_PROB]
    alias = flat[rec + _ROW_ALIAS]
    # +0.5 before the truncating cast rounds the exact-integer alias
    f = torch.where(frac < prob, f0, (alias + 0.5).long())   # [K, N]
    first = (piece + f) * width + _ROW_TRI
    tri = flat[first[..., None] + torch.arange(9, device=records.device)]
    out = _mix(tri, uniforms)
    return (out, f.to(torch.int32)) if return_draws else out


def sample_chunked_plain(table, meta, slots, uniforms, return_draws=False):
    """Plain version of `sample_chunked_cuda` (JAX `_sample_chunked_ref`,
    device_sampler.py:404-431), by flat gathers."""
    fc = table.shape[2]
    flat = table.reshape(-1)
    sl = slots.long()
    f0, frac = _draw_face(uniforms[:, 0], meta[_META_NF, sl])
    row = meta[_META_BASE, sl].long()[:, None] + f0 // fc     # [K, N]
    col = f0 % fc
    prob = flat[(row * _N_ROWS_C + _CROW_PROB) * fc + col]
    accept = frac < prob
    first = torch.where(accept, _CROW_TRI, _CROW_ATRI)       # [K, N]
    rows = (row * _N_ROWS_C + first)[..., None] + \
        torch.arange(9, device=table.device)
    tri = flat[rows * fc + col[..., None]]                   # [K, N, 9]
    out = _mix(tri, uniforms)
    if not return_draws:
        return out
    return out, torch.where(accept, f0, -1 - f0).to(torch.int32)


def sample_records_plain(records, meta, slots, uniforms, return_draws=False):
    """Plain version of `sample_chunked_cuda`, on its inputs: the draw of
    `sample_chunked_plain` read from the face-major records, by flat
    gathers."""
    fc = records.shape[1]
    flat = records.reshape(-1)
    sl = slots.long()
    f0, frac = _draw_face(uniforms[:, 0], meta[_META_NF, sl])
    rec = (meta[_META_BASE, sl].long()[:, None] * fc + f0) * _N_ROWS_C
    accept = frac < flat[rec + _CROW_PROB]                   # [K, N]
    first = rec + torch.where(accept, _CROW_TRI, _CROW_ATRI)
    tri = flat[first[..., None] + torch.arange(9, device=records.device)]
    out = _mix(tri, uniforms)
    if not return_draws:
        return out
    return out, torch.where(accept, f0, -1 - f0).to(torch.int32)


# ---------------------------------------------------------------------------
# dispatch and the wire
# ---------------------------------------------------------------------------


def sample_packed_ref(table, n_faces, slots, uniforms, return_draws=False):
    """Plain version of either layout on its JAX layout (`jax_table`),
    picked by the table's row extent (16 rows dense, 24 chunked): [K] slots
    + [K, 3, N] uniforms -> [K, N, 3] f32."""
    fn = sample_chunked_plain if table.shape[1] == _N_ROWS_C \
        else sample_dense_plain
    return fn(table, n_faces, slots, uniforms, return_draws=return_draws)


def _sample_points(table, n_faces, slots, uniforms, return_draws=False):
    """[K] slots + [K, 3, N] uniforms -> [K, N, 3] f32 (JAX
    device_sampler.py:357-392): the kernel of the table's layout on a CUDA
    tensor, its plain version on a CPU tensor, either drawing from the
    table's records (`table_records`).  A dense table in the JAX layout
    ([n_pieces, 16, Fmax]) takes its plain version on the CPU; the kernel
    refuses it."""
    cpu = table.device.type == 'cpu'
    if table.dim() == 4:
        fn = sample_dense_records_plain if cpu else sample_dense_cuda
    elif table.shape[1] == _N_ROWS_C:
        fn = sample_records_plain if cpu else sample_chunked_cuda
    elif cpu:
        return sample_dense_plain(table, n_faces, slots, uniforms,
                                  return_draws=return_draws)
    else:
        fn = sample_dense_cuda
    return fn(table_records(table), n_faces, slots, uniforms,
              return_draws=return_draws)


def sample_packed(table, n_faces, slots, generator, n_points):
    """Draw [K, n_points, 3] area-weighted surface samples on the table's
    device (JAX device_sampler.py:395-401)."""
    uniforms = torch.rand((slots.shape[0], 3, n_points), generator=generator,
                          device=table.device)
    return _sample_points(table, n_faces, slots, uniforms)


def sample_and_expand(table, n_faces, slots, counts, seed, n_points,
                      max_parts, data_keys):
    """Slot wire -> full dense batch on the table's device (JAX
    device_sampler.py:464-478): sample with a generator seeded from
    (_BASE_KEY, seed), then the expansion of `expand_geometry_batch`.

    Args:
        slots: [K] int32 and counts: [B] int32, on the table's device
        seed: the batch's `sample_seed` (a Python int)
    """
    generator = torch.Generator(device=table.device)
    generator.manual_seed((_BASE_KEY << 32) | (int(seed) & 0xffffffff))
    packed = sample_packed(table, n_faces, slots, generator, n_points)
    return expand_geometry_batch(packed, counts, max_parts=max_parts,
                                 data_keys=data_keys)
