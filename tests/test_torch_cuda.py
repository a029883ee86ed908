"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: distances bit for bit and witnesses exactly (the kernel
computes the plain version's expression with every operation rounded on
its own; B1/B3's pruned list equals its dense list exactly, and so does
its keep rule the plain one's); B2/B4's gradients bit for bit from one
launch to the next (each row's terms are added in a fixed order), and
within 1e-5 of the largest gradient (plus 1e-6) of the plain version on
the card, whose index_add_ adds by global atomics in a varying order;
padded parts' gradients exactly 0.  The same holds for B7 and B8 and for
the card against the CPU.  The sampling kernels' points
bit for bit and their face draws exactly, for the same reason, on the card
and against the CPU (the plain versions take a correctly rounded square
root, as the kernels do).  Losses on the card within 1e-5 relative of the
CPU's.  The LAP kernel's assignments equal the plain version's exactly, on
the card and on the CPU (the same arithmetic in the same order, ties to
the first minimum).  DGCNN's neighbourhood reduce: max and min exactly,
sums within 1e-6 relative to the largest magnitude, its backward bitwise
from one launch to the next (it adds by sorted index); each encoder in
train mode, the card given the CPU's kNN graphs, FPS samples and ball
sets: outputs atol 1e-4, rtol 1e-4, gradients 1e-3 relative L2 plus twice
the card gradient's own movement under relative 1e-7 and 1e-6 nudges of
the clouds.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from multi_part_assembly_tpu_torch.datasets import \
    device_sampler as TDS  # noqa: E402
from multi_part_assembly_tpu_torch.datasets.mesh_io import \
    MeshSampler  # noqa: E402
from multi_part_assembly_tpu_torch.ops import chamfer as TC  # noqa: E402
from multi_part_assembly_tpu_torch.ops import \
    matching as TM  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _inputs(device, B=2, P=10, N=40, nparts=(6, 10), seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, P, N, 3).astype(np.float32)
    y = rng.randn(B, P, N, 3).astype(np.float32)
    valids = (np.arange(P)[None] <
              np.asarray(nparts)[:, None]).astype(np.float32)
    return [torch.tensor(v, device=device) for v in (x, y, valids)]


@pytest.mark.cuda
@pytest.mark.parametrize('diagonal', [False, True])
def test_kernels_match_plain(cuda, diagonal):
    x, y, valids = _inputs(cuda)
    kern = TC.chamfer_witnesses(x, y, valids, diagonal=diagonal)
    plain = TC.chamfer_witnesses(x, y, valids, diagonal=diagonal,
                                 plain=True)
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)
    weights = [torch.rand(kern[0].shape, device=cuda) for _ in range(2)]
    grads = []
    for plain_mode in (False, True):
        xt, yt = x.clone().requires_grad_(), y.clone().requires_grad_()
        d1, d2, _, _ = TC.chamfer_witnesses(xt, yt, valids,
                                            diagonal=diagonal,
                                            plain=plain_mode)
        ((d1 * weights[0]).sum() + (d2 * weights[1]).sum()).backward()
        grads.append((xt.grad, yt.grad))
    for k, p in zip(*grads):
        torch.testing.assert_close(k, p, atol=1e-5 * float(p.abs().max()),
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['chamfer_parts', 'chamfer_diag'])
def test_card_matches_cpu(cuda, name):
    """Kernel distances equal the CPU plain version's bit for bit."""
    fn = getattr(TC, name)
    on_card = fn(*_inputs(cuda))
    on_cpu = fn(*_inputs('cpu'))
    for k, c in zip(on_card, on_cpu):
        assert torch.equal(k.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['chamfer_parts', 'chamfer_diag'])
def test_card_grads_match_cpu(cuda, name):
    """Gradients through the kernels (B1-B4) against the CPU's plain
    version: with dy, without it, and with an unused distance."""
    fn = getattr(TC, name)
    w = torch.rand((2, 10, 40), generator=torch.Generator().manual_seed(0))
    for need_dy, use2 in ((True, True), (False, True), (True, False)):
        out = {}
        for device in ('cpu', cuda):
            x, y, valids = _inputs(device)
            x.requires_grad_()
            y.requires_grad_(need_dy)
            d1, d2 = fn(x, y, valids)
            loss = (d1 * w.to(device).reshape(d1.shape)).sum()
            if use2:
                loss = loss + d2.sum()
            loss.backward()
            out[str(device)] = [x.grad.cpu()] + (
                [y.grad.cpu()] if need_dy else [])
            assert need_dy or y.grad is None
        for k, c in zip(out['cuda'], out['cpu']):
            torch.testing.assert_close(
                k, c, atol=1e-5 * float(c.abs().max()) + 1e-6, rtol=0)


@pytest.mark.cuda
def test_launch_counters(cuda):
    """Each wrapper counts its own launches: one main launch a forward call
    (both directions), one backward launch a call (both directions).  The
    fused route launches no B7 or B8."""
    x, y, valids = _inputs(cuda)
    x.requires_grad_()
    TC.reset_launches()
    d1, d2 = TC.chamfer_parts(x, y, valids)
    (d1.sum() + d2.sum()).backward()
    TC.chamfer_diag(x.detach(), y, valids)
    assert TC.LAUNCHES == {'nn_parts': 1, 'nn_diag': 1, 'bwd_parts': 1,
                           'bwd_diag': 0, 'nn_off': 0, 'nn_dir': 0}


@pytest.fixture
def unfused():
    TC.set_fused_mode('off')
    yield
    TC.set_fused_mode('auto')


@pytest.mark.cuda
def test_unfused_route_launch_counters(cuda, unfused):
    """The unfused route launches B8 once per direction and none of B1-B4;
    chamfer_distance launches B7 once per direction."""
    x, y, valids = _inputs(cuda)
    x.requires_grad_()
    TC.reset_launches()
    d1, d2 = TC.chamfer_parts(x, y, valids)
    (d1.sum() + d2.sum()).backward()
    TC.chamfer_diag(x.detach(), y, valids)
    TC.chamfer_distance(x.detach()[:, 0], y[:, 1])
    assert TC.LAUNCHES == {'nn_parts': 0, 'nn_diag': 0, 'bwd_parts': 0,
                           'bwd_diag': 0, 'nn_off': 4, 'nn_dir': 2}


def _pair_clouds(device, B, P, N, nparts, kind, seed=0):
    """Part clouds for B1-B4 and B8: 'spread' parts (0.1-scale around
    centres in [-2, 2]^3, so pruning drops pairs), 'ties' (half the centres
    at 0, coordinates on a 1/64 grid, duplicated points), 'overlap' (every
    centre at 0) or 'collapsed' (spread, with every y part shrunk to its
    first 4 points, so that witnesses crowd onto a few points in both
    directions)."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-2, 2, (B, P, 1, 3))
    if kind == 'ties':
        centres[:, ::2] = 0.0
    if kind == 'overlap':
        centres[:] = 0.0
    x = centres + 0.1 * rng.randn(B, P, N, 3)
    y = x + 0.02 * rng.randn(B, P, N, 3)
    if kind == 'ties':
        x, y = np.round(x * 64) / 64, np.round(y * 64) / 64
        dup = np.arange(1, N, 4)
        x[:, :, dup] = x[:, :, dup - 1]
    if kind == 'collapsed':
        y = np.ascontiguousarray(y[:, :, np.arange(N) % 4])
    n_parts = torch.tensor(nparts, dtype=torch.int32, device=device)
    return (torch.tensor(x, dtype=torch.float32, device=device),
            torch.tensor(y, dtype=torch.float32, device=device), n_parts)


# (B, P, N, part counts, kind): N = 1300 is more than one 512-point target
# stage and one 1024-point query chunk, not a multiple of the 8-target
# group, and two chunks of B2/B4's owned points
PAIR_CASES = {
    'ties': (2, 6, 200, (6, 3), 'ties'),
    'one_part': (3, 1, 100, (1, 0, 1), 'spread'),
    'none_and_all': (3, 5, 64, (0, 5, 2), 'spread'),
    'one_point': (2, 4, 1, (4, 2), 'spread'),
    'long_parts': (2, 3, 1300, (3, 2), 'ties'),
    'collapsed': (3, 6, 300, (6, 4, 1), 'collapsed'),
    'overlap': (2, 5, 300, (5, 3), 'overlap'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(PAIR_CASES))
def test_pair_kernel_matches_plain(cuda, case):
    """B1/B3 against the plain version bit for bit, witnesses included, on
    the pruned and the dense list; the card's keep rule against the plain
    one."""
    B, P, N, nparts, kind = PAIR_CASES[case]
    x, y, n_parts = _pair_clouds(cuda, B, P, N, nparts, kind)
    work = torch.empty(1 + B * P * P, dtype=torch.int32, device=cuda)
    for diagonal in (False, True):
        plain = TC.nn_pair_plain(x, y, n_parts, diagonal)
        for prune in (True, False):
            kern = TC.nn_pair_cuda(x, y, n_parts, diagonal, prune=prune,
                                   work=work)
            for k, p in zip(kern, plain):
                assert torch.equal(k, p), (diagonal, prune)
    TC.nn_pair_cuda(x, y, n_parts, False, prune=True, work=work)
    assert torch.equal(TC.work_keep(work, B, P),
                       TC.prune_keep_plain(x, y, n_parts))


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['whole', 'diag'])
@pytest.mark.parametrize('case', sorted(PAIR_CASES))
def test_nn_parts_kernel_matches_plain(cuda, case, form):
    """B8 against its plain version, both directions: distances bit for
    bit, indices exactly, 0 and 0 at padded parts; in the whole-shape form
    and in the B*P one-part form of the diagonal (0/1 counts); and against
    B1 on the same clouds, its witnesses renumbered."""
    B, P, N, nparts, kind = PAIR_CASES[case]
    x, y, n_parts = _pair_clouds(cuda, B, P, N, nparts, kind)
    if form == 'diag':
        n_parts = (torch.arange(P, device=cuda)[None] <
                   n_parts[:, None]).to(torch.int32).reshape(B * P)
        x, y = x.view(B * P, 1, N, 3), y.view(B * P, 1, N, 3)
    npad = (N + 127) // 128 * 128
    valid = (torch.arange(x.shape[1], device=cuda)[None] <
             n_parts[:, None])[..., None].expand(x.shape[:3])
    _, _, w1, w2 = TC.nn_pair_cuda(x, y, n_parts, False)
    d1, d2 = TC.nn_pair_plain(x, y, n_parts, False)[:2]
    for q, t, d_b1, w_b1 in ((x, y, d1, w1), (y, x, d2, w2)):
        kern = TC.nn_parts_cuda(q, t, n_parts)
        plain = TC.nn_parts_plain(q, t, n_parts)
        for k, p in zip(kern, plain):
            assert torch.equal(k, p)
        assert not kern[0][~valid].any() and not kern[1][~valid].any()
        assert torch.equal(kern[0], d_b1)
        idx = kern[1].long()
        renumbered = torch.where(valid, idx // npad * N + idx % npad, -1)
        assert torch.equal(renumbered.to(torch.int32), w_b1)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(PAIR_CASES))
def test_grad_kernel_matches_plain(cuda, case):
    """B2/B4 against `chamfer_grad_plain` in both modes, with and without
    dy, with either cotangent null, within 1e-5 of the largest gradient
    (plus 1e-6); exact zeros at padded parts, whose cotangents are not 0."""
    B, P, N, nparts, kind = PAIR_CASES[case]
    x, y, n_parts = _pair_clouds(cuda, B, P, N, nparts, kind)
    g = torch.Generator(device=cuda).manual_seed(1)
    g1 = torch.rand((B, P, N), generator=g, device=cuda) + 0.5
    g2 = torch.rand((B, P, N), generator=g, device=cuda) + 0.5
    pad = torch.arange(P, device=cuda)[None] >= n_parts[:, None]
    for diagonal in (False, True):
        _, _, w1, w2 = TC.nn_pair_cuda(x, y, n_parts, diagonal)
        for c1, c2 in ((g1, g2), (None, g2), (g1, None)):
            for need_dy in (True, False):
                args = (x, y, n_parts, w1, w2, c1, c2, diagonal, need_dy)
                kern = TC.chamfer_grad_cuda(*args)
                plain = TC.chamfer_grad_plain(*args)
                torch.cuda.synchronize()
                assert (kern[1] is None) != need_dy
                for k, p in zip(kern, plain):
                    if p is None:
                        continue
                    tol = 1e-5 * float(p.abs().max()) + 1e-6
                    torch.testing.assert_close(k, p, atol=tol, rtol=0)
                    assert (k[pad] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(PAIR_CASES))
def test_grad_kernel_deterministic(cuda, case):
    """B2/B4 give the same bits on every launch: three launches on the
    same inputs, in both modes, with and without dy, with either cotangent
    null, bitwise equal dx and dy (a collapsed cloud sends many witnesses
    to one row, where an order that followed the warps' timing would
    show)."""
    B, P, N, nparts, kind = PAIR_CASES[case]
    x, y, n_parts = _pair_clouds(cuda, B, P, N, nparts, kind)
    g = torch.Generator(device=cuda).manual_seed(2)
    g1 = torch.rand((B, P, N), generator=g, device=cuda) + 0.5
    g2 = torch.rand((B, P, N), generator=g, device=cuda) + 0.5
    for diagonal in (False, True):
        _, _, w1, w2 = TC.nn_pair_cuda(x, y, n_parts, diagonal)
        for c1, c2 in ((g1, g2), (None, g2), (g1, None)):
            for need_dy in (True, False):
                args = (x, y, n_parts, w1, w2, c1, c2, diagonal, need_dy)
                runs = [TC.chamfer_grad_cuda(*args) for _ in range(3)]
                torch.cuda.synchronize()
                for run in runs[1:]:
                    for k, first in zip(run, runs[0]):
                        if first is None:
                            assert k is None
                            continue
                        assert torch.equal(k.view(torch.int32),
                                           first.view(torch.int32)), \
                            (diagonal, c1 is None, c2 is None, need_dy)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(PAIR_CASES))
def test_grad_kernel_matches_cpu_plain_bitwise(cuda, case):
    """B2/B4 add each row's terms in the order of the plain version on the
    CPU (its own term, then its sources in ascending order), so they give
    its gradients bit for bit."""
    B, P, N, nparts, kind = PAIR_CASES[case]
    x, y, n_parts = _pair_clouds(cuda, B, P, N, nparts, kind)
    g = torch.Generator(device=cuda).manual_seed(3)
    g1 = torch.rand((B, P, N), generator=g, device=cuda) + 0.5
    g2 = torch.rand((B, P, N), generator=g, device=cuda) + 0.5
    for diagonal in (False, True):
        _, _, w1, w2 = TC.nn_pair_cuda(x, y, n_parts, diagonal)
        for c1, c2 in ((g1, g2), (None, g2), (g1, None)):
            for need_dy in (True, False):
                args = (x, y, n_parts, w1, w2, c1, c2, diagonal, need_dy)
                kern = TC.chamfer_grad_cuda(*args)
                plain = TC.chamfer_grad_plain(*[
                    a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args])
                for k, p in zip(kern, plain):
                    if p is not None:
                        assert torch.equal(k.cpu(), p), (diagonal, need_dy)


@pytest.mark.cuda
def test_work_list_dense_and_pruned(cuda):
    """The whole-shape call visits every pair of valid parts by default
    and the pairs of the keep rule with `prune`, which drops pairs of
    spread-out parts; the diagonal call visits (i, i)."""
    B, P = 3, 6
    x, y, n_parts = _pair_clouds(cuda, B, P, 50, (6, 4, 1), 'spread')
    valid = torch.arange(P, device=cuda)[None] < n_parts[:, None]
    pairs = valid[:, :, None] & valid[:, None, :]
    work = torch.empty(1 + B * P * P, dtype=torch.int32, device=cuda)
    TC.nn_pair_cuda(x, y, n_parts, False, work=work)
    assert torch.equal(TC.work_keep(work, B, P), pairs)
    TC.nn_pair_cuda(x, y, n_parts, True, work=work)
    assert torch.equal(TC.work_keep(work, B, P),
                       pairs & torch.eye(P, dtype=torch.bool, device=cuda))
    TC.nn_pair_cuda(x, y, n_parts, False, prune=True, work=work)
    kept = TC.work_keep(work, B, P)
    assert torch.equal(kept, TC.prune_keep_plain(x, y, n_parts))
    assert int(kept.sum()) < int(pairs.sum())


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(3, 1000, 2500), (2, 37, 5),
                                   (70000, 3, 4)],
                         ids=['n1_ne_n2', 'tiny', 'grid_chunks'])
def test_nn_dir_kernel_matches_plain(cuda, shape):
    """B7 against its plain version; 70000 clouds take two launches."""
    B, N1, N2 = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((B, N1, 3), generator=g, device=cuda)
    y = torch.randn((B, N2, 3), generator=g, device=cuda)
    for k, p in zip(TC.nn_dir_cuda(x, y), TC.nn_dir_plain(x, y)):
        assert torch.equal(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['chamfer_parts', 'chamfer_diag'])
def test_unfused_card_matches_cpu(cuda, unfused, name):
    """Under 'off', B8's distances equal the CPU plain version's bit for
    bit, and the plain backward's gradients agree to rounding."""
    fn = getattr(TC, name)
    out = {}
    for device in ('cpu', cuda):
        x, y, valids = _inputs(device)
        x.requires_grad_()
        y.requires_grad_()
        d1, d2 = fn(x, y, valids)
        w = torch.rand(d1.shape, generator=torch.Generator().manual_seed(0))
        ((d1 * w.to(device)).sum() + d2.sum()).backward()
        out[str(device)] = [v.detach().cpu() for v in (d1, d2, x.grad, y.grad)]
    card, cpu = out['cuda'], out['cpu']
    for k, c in zip(card[:2], cpu[:2]):
        assert torch.equal(k, c)
    for k, c in zip(card[2:], cpu[2:]):
        torch.testing.assert_close(k, c, atol=1e-5 * float(c.abs().max()),
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('dense_limit', [2**27, 0], ids=['dense', 'scan'])
def test_repulsion_card_matches_cpu(cuda, dense_limit):
    """repulsion_cd_loss through B7 on the card against the CPU, and the
    kernel against its plain version on the card (loss bit for bit)."""
    from multi_part_assembly_tpu_torch.utils.loss import repulsion_cd_loss
    rng = np.random.RandomState(1)
    pts = (0.05 * rng.randn(2, 6, 200, 3)).astype(np.float32)
    valids = (np.arange(6)[None] < np.asarray([[3], [6]])).astype(np.float32)
    out = {}
    for device, plain in (('cpu', True), (cuda, False), (cuda, True)):
        p = torch.tensor(pts, device=device, requires_grad=True)
        loss = repulsion_cd_loss(p, torch.tensor(valids, device=device),
                                 0.01, dense_limit, plain=plain)
        loss.sum().backward()
        out[(str(device), plain)] = (loss.detach().cpu(), p.grad.cpu())
    (l_cpu, g_cpu), (l_k, g_k), (l_p, g_p) = out.values()
    assert torch.equal(l_k, l_p)
    torch.testing.assert_close(g_k, g_p, atol=1e-5 * float(g_p.abs().max()),
                               rtol=0)
    torch.testing.assert_close(l_k, l_cpu, rtol=1e-5, atol=0)


def _soup_tables(folder, layout, device, faces=(37, 512, 3000, 600)):
    """Sampling tables of random triangle soups whose face counts span
    sub-chunk, one-chunk and many-chunk pieces."""
    paths = []
    for i, nf in enumerate(faces):
        v = np.random.default_rng(i).normal(size=(nf * 3, 3))
        path = str(folder / f'soup{i}.obj')
        with open(path, 'w') as f:
            f.writelines(f'v {x} {y} {z}\n' for x, y, z in v)
            f.writelines(f'f {3 * j + 1} {3 * j + 2} {3 * j + 3}\n'
                         for j in range(nf))
        paths.append(path)
    return TDS.build_device_tables(paths, MeshSampler(), device=device,
                                   layout=layout)


def _sampler_inputs(device, n_pieces=4, K=50, N=1000, seed=0):
    rng = np.random.default_rng(seed)
    slots = torch.tensor(rng.integers(0, n_pieces, K), dtype=torch.int32,
                         device=device)
    u = torch.tensor(rng.random((K, 3, N), np.float32), device=device)
    return slots, u


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['dense', 'chunked'])
def test_sampler_kernels_match_plain(cuda, tmp_path, layout):
    """B5 and B6, each on its table's face-major records, against the
    plain versions on the same inputs and on the table itself, on the card
    and on the CPU, bit for bit, draws included."""
    tables = _soup_tables(tmp_path, layout, cuda)
    slots, u = _sampler_inputs(cuda)
    kern = TDS._sample_points(tables.table, tables.n_faces, slots, u,
                              return_draws=True)
    table = TDS.jax_table(tables.table)
    plains = [TDS.sample_packed_ref(table, tables.n_faces, slots, u,
                                    return_draws=True),
              TDS.sample_packed_ref(table.cpu(), tables.n_faces.cpu(),
                                    slots.cpu(), u.cpu(), return_draws=True)]
    records_plain = TDS.sample_records_plain if layout == 'chunked' else \
        TDS.sample_dense_records_plain
    plains.append(records_plain(TDS.table_records(tables.table),
                                tables.n_faces, slots, u, return_draws=True))
    for plain in plains:
        for k, p in zip(kern, plain):
            assert torch.equal(k.cpu(), p.cpu())


@pytest.mark.cuda
def test_sampler_layouts_agree_and_count(cuda, tmp_path):
    dense = _soup_tables(tmp_path, 'dense', cuda)
    chunk = _soup_tables(tmp_path, 'chunked', cuda)
    slots, u = _sampler_inputs(cuda, seed=1)
    TDS.reset_launches()
    pd = TDS._sample_points(dense.table, dense.n_faces, slots, u)
    pc = TDS._sample_points(chunk.table, chunk.n_faces, slots, u)
    assert torch.equal(pd, pc)
    assert TDS.LAUNCHES == {'sample_dense': 1, 'sample_chunked': 1}
    with pytest.raises(ValueError, match='uniforms'):
        TDS.sample_dense_cuda(TDS.table_records(dense.table), dense.n_faces,
                              slots, u[:, :2])
    bad = torch.full_like(slots, 4)
    for t, kernel in ((dense, TDS.sample_dense_cuda),
                      (chunk, TDS.sample_chunked_cuda)):
        # a table in the JAX layout (not the records, nor a view of them)
        # raises rather than being copied each call
        table = TDS.jax_table(t.table)
        with pytest.raises(ValueError, match='records: expected'):
            TDS._sample_points(table.contiguous(), t.n_faces, slots, u)
        with pytest.raises(ValueError, match='records: expected shape'):
            kernel(table, t.n_faces, slots, u)
        # a slot outside [0, n_pieces) gives NaN points, not another
        # piece's
        assert torch.isnan(kernel(TDS.table_records(t.table), t.n_faces,
                                  bad, u)).all()
    assert TDS.LAUNCHES == {'sample_dense': 2, 'sample_chunked': 2}


def _lap_costs(kind, M, n, seed):
    rng = np.random.default_rng(seed)
    if kind == 'random':
        return rng.random((M, n, n)).astype(np.float32)
    if kind == 'ties':
        return rng.integers(0, 3, (M, n, n)).astype(np.float32)
    groups = torch.tensor(rng.integers(0, max(2, n // 3), (M, n)))
    base = torch.tensor((0.01 * rng.random((M, n, n))).astype(np.float32))
    return TM.lap_cost(base, groups).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['random', 'ties', 'blocks'])
@pytest.mark.parametrize('M,n', [(160, 20), (32, 20), (7, 2), (9, 3),
                                 (5, 32), (3, 1)])
def test_lap_kernel_matches_plain(cuda, kind, M, n):
    """Kernel L1 against solve_lap_plain on the card and on the CPU: the
    same assignment exactly; one launch counted."""
    cost = _lap_costs(kind, M, n, seed=M + n)
    TM.reset_launches()
    got = TM.solve_lap(torch.tensor(cost, device=cuda))
    torch.cuda.synchronize()
    assert TM.LAUNCHES['lap'] == 1
    assert got.dtype == torch.int32 and got.shape == (M, n)
    plain = TM.solve_lap_plain(torch.tensor(cost, device=cuda))
    cpu = TM.solve_lap_plain(torch.tensor(cost))
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_lap_kernel_refuses_more_than_32_columns(cuda):
    with pytest.raises(ValueError, match='n <= 32'):
        TM.solve_lap(torch.zeros((2, 33, 33), device=cuda))
    out = TM.solve_lap(torch.zeros((0, 4, 4), device=cuda))
    assert out.shape == (0, 4)


@pytest.mark.cuda
def test_neighborhood_reduce_card_matches_cpu_and_is_deterministic(cuda):
    from multi_part_assembly_tpu_torch.ops import knn as TK
    rng = np.random.RandomState(0)
    u = rng.randn(4, 500, 64).astype(np.float32)
    # many rows share a few neighbours: heavy collisions in the backward
    idx = rng.randint(0, 20, (4, 500, 20))
    cot = [torch.tensor(rng.randn(4, 500, 64).astype(np.float32))
           for _ in range(4)]

    def run(device):
        ut = torch.tensor(u, device=device, requires_grad=True)
        out = TK.neighborhood_reduce(ut, torch.tensor(idx, device=device))
        sum((o * c.to(device)).sum() for o, c in zip(out, cot)).backward()
        return [o.detach().cpu() for o in out], ut.grad.cpu()

    (out_c, g_c), (out_g, g_g), (_, g_again) = run('cpu'), run(cuda), \
        run(cuda)
    assert torch.equal(out_g[0], out_c[0]) and torch.equal(out_g[1],
                                                           out_c[1])
    for a, b in zip(out_g[2:] + [g_g], out_c[2:] + [g_c]):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            1.0, float(b.abs().max()))
    assert torch.equal(g_g, g_again)


def _encoder_step(net, x, mask, cot, device, given=None):
    """Train-mode forward and backward of sum(out * cot) on `device`, the
    port's indices given (or recorded): (out, flat gradient, recording)."""
    from multi_part_assembly_tpu_torch.ops import knn as TK
    from multi_part_assembly_tpu_torch.ops import sampling as TS
    given = given or {}
    TK.set_knn_override(given.get('graph'), record=True)
    TS.set_sampling_override(given.get('fps'), given.get('ball'),
                             record=True)
    try:
        net = net.to(device).train()
        net.zero_grad(set_to_none=True)
        out = net(x.to(device), mask.to(device))
        (out * cot.to(device)).sum().backward()
        rec = dict(graph=list(TK.knn_calls()),
                   fps=list(TS.sampling_calls()['fps']),
                   ball=list(TS.sampling_calls()['ball']))
    finally:
        TK.set_knn_override()
        TS.set_sampling_override()
    grad = torch.cat([p.grad.reshape(-1).cpu() for p in net.parameters()])
    return out.detach().cpu(), grad, rec


@pytest.mark.cuda
@pytest.mark.parametrize('arch', ['dgcnn', 'pointnet2_ssg',
                                  'pointnet2_msg'])
def test_encoder_card_matches_cpu(cuda, arch):
    from multi_part_assembly_tpu_torch.models.modules.encoders import \
        build_encoder
    torch.manual_seed(0)
    net = build_encoder(arch, 32)
    rng = np.random.RandomState(1)
    mask = torch.tensor([1.0, 0.0, 1.0])
    x = torch.tensor((0.4 * rng.randn(3, 600, 3)).astype(np.float32)) * \
        mask[:, None, None]
    cot = torch.tensor(rng.randn(3, 32).astype(np.float32))
    out_c, g_c, given = _encoder_step(net, x, mask, cot, 'cpu')
    out_g, g_g, _ = _encoder_step(net, x, mask, cot, cuda, given)
    jitter = 0.0
    d = torch.tensor(np.random.RandomState(9).randn(*x.shape).astype(
        np.float32))
    for eps in (1e-7, 1e-6):
        g_n = _encoder_step(net, x * (1 + eps * d), mask, cot, cuda,
                            given)[1]
        jitter = max(jitter, float((g_n - g_g).norm() / g_g.norm()))
    torch.testing.assert_close(out_g, out_c, atol=1e-4, rtol=1e-4)
    assert float((g_g - g_c).norm() / g_c.norm()) <= 1e-3 + 2 * jitter


_SYNC_BN_RANK = """
import sys, torch
sys.path.insert(0, {root!r})
from multi_part_assembly_tpu_torch.models.modules.norm import MaskedBatchNorm
from multi_part_assembly_tpu_torch.parallel import dist
device = dist.init_distributed('cuda')
r = dist.rank()
inp = torch.load(sys.argv[1])
half = inp['x'].shape[0] // 2
rows = slice(r * half, (r + 1) * half)
bn = MaskedBatchNorm(inp['x'].shape[-1], lean=inp['lean']).to(device)
bn.train()
x = inp['x'][rows].to(device).requires_grad_(True)
out = bn(x, inp['mask'][rows].to(device))
(out * inp['g'][rows].to(device)).sum().backward()
torch.save({{'backend': torch.distributed.get_backend(),
            'device': str(device), 'out': out.detach().cpu(),
            'dx': x.grad.cpu(),
            'dweight': dist.all_reduce_(bn.weight.grad.clone()).cpu(),
            'running_mean': bn.running_mean.cpu(),
            'running_var': bn.running_var.cpu()}}, sys.argv[2])
dist.barrier()
dist.destroy()
"""


@pytest.mark.cuda
@pytest.mark.parametrize('lean', [False, True])
def test_sync_bn_two_gloo_ranks_on_one_card(cuda, lean, tmp_path):
    """Sync MaskedBatchNorm on two gloo ranks sharing cuda:0, each on half
    the batch, equals one process on the whole batch on the card: outputs
    and input gradients atol 1e-5, weight gradients and running statistics
    atol 1e-5, rtol 1e-5."""
    from torch_ddp_worker import ROOT, spawn_ranks
    from multi_part_assembly_tpu_torch.models.modules.norm import \
        MaskedBatchNorm
    rng = np.random.RandomState(3)
    valids = np.arange(5)[None] < np.asarray([2, 5, 1, 4])[:, None]
    inp = {'lean': lean,
           'x': torch.tensor(rng.randn(4, 5, 16, 32).astype(np.float32)),
           'mask': torch.tensor(valids[..., None].astype(np.float32)),
           'g': torch.tensor(rng.randn(4, 5, 16, 32).astype(np.float32))}
    torch.save(inp, tmp_path / 'in.pt')
    spawn_ranks(lambda r: ['-c', _SYNC_BN_RANK.format(root=ROOT),
                           str(tmp_path / 'in.pt'),
                           str(tmp_path / f'out{r}.pt')], timeout=240)
    res = [torch.load(tmp_path / f'out{r}.pt') for r in range(2)]
    bn = MaskedBatchNorm(32, lean=lean).to(cuda)
    bn.train()
    x = inp['x'].to(cuda).requires_grad_(True)
    out = bn(x, inp['mask'].to(cuda))
    (out * inp['g'].to(cuda)).sum().backward()
    for r in res:
        assert r['backend'] == 'gloo' and r['device'] == 'cuda:0'
    torch.testing.assert_close(torch.cat([r['out'] for r in res]),
                               out.detach().cpu(), atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.cat([r['dx'] for r in res]),
                               x.grad.cpu(), atol=1e-5, rtol=0)
    for r in res:
        for name, want in (('dweight', bn.weight.grad),
                           ('running_mean', bn.running_mean),
                           ('running_var', bn.running_var)):
            torch.testing.assert_close(r[name], want.cpu(), atol=1e-5,
                                       rtol=1e-5)


def _graph_trainers(synth, tmp_path, opts):
    """Two flagship Trainers at a small width on the card from the same
    seed: one that replays the captured step, one that runs it eagerly."""
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    from multi_part_assembly_tpu_torch.utils import config_utils as TCFG
    flagship = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'configs/pn_transformer/pn_transformer/'
        'pn_transformer-32x1-cosine_400e-everyday.py')
    trainers = []
    for name in ('graph', 'eager'):
        cfg = TCFG.load_cfg_file(flagship).merge_from_list([
            'data.data_dir', synth, 'exp.num_epochs', '2',
            'exp.val_every', '1', 'exp.val_sample_vis', '0',
            'exp.batch_size', '2', 'exp.steps_per_call', '2',
            'model.pc_feat_dim', '16', 'model.transformer_feat_dim', '32',
            'model.transformer_heads', '4', 'model.transformer_layers', '2',
            'data.max_num_part', '6', 'data.num_pc_points', '64', *opts])
        cfg.freeze()
        trainers.append(Trainer(cfg, 'cuda', ckp_dir=str(tmp_path / name),
                                resume=False, quiet=True))
    trainers[1].compiled = None
    return trainers


@pytest.mark.cuda
@pytest.mark.parametrize('sampling', ['False', 'True'])
def test_graph_replays_equal_eager_steps(cuda, tmp_path, sampling):
    """Two epochs of 4 flagship steps at a small width, in groups of 2, as
    replays of the captured CUDA graph and as eager steps from the same
    weights and generator states (host wire and slot wire): parameters,
    buffers, Adam state and every logged value bitwise equal; one capture,
    every step a replay."""
    import json
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'scripts'))
    from make_synthetic_data import generate
    os.environ['MPA_MESH_CACHE_DIR'] = str(tmp_path / 'mesh_cache')
    synth = generate(str(tmp_path / 'data'), n_shapes=8, min_parts=2,
                     max_parts=6, seed=0)
    graph, eager = _graph_trainers(
        synth, tmp_path, ['data.device_sampling', sampling])
    rng = torch.cuda.get_rng_state()  # dropout's stream, shared
    rows = []
    for trainer in (graph, eager):
        torch.cuda.set_rng_state(rng)
        for epoch in range(2):
            trainer.train_epoch(epoch)
        trainer.close()
        with open(os.path.join(trainer.ckp_dir, 'metrics.jsonl')) as f:
            rows.append([{k: v for k, v in json.loads(line).items()
                          if k != 'train/data_time'} for line in f])
    assert graph.compiled.captures == 1 and graph.compiled.replays == 8
    assert rows[0] == rows[1] and len(rows[0]) == 8
    states = []
    for trainer in (graph, eager):
        state = list(trainer.model.state_dict().items())
        for pid, st in sorted(trainer.optimizer.state_dict()['state']
                              .items()):
            state += [(f'opt.{pid}.{k}', v) for k, v in sorted(st.items())]
        states.append(state)
    assert [n for n, _ in states[0]] == [n for n, _ in states[1]]
    for (name, a), (_, b) in zip(*states):
        assert torch.equal(a, b), name
