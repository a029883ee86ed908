"""The port's nearest-neighbour kernels' plain versions (B7, B8), the
reference chamfer API and the repulsion loss, against the JAX package.

The same numpy clouds (from a seed) go through the JAX package on the CPU
backend and through the port on CPU tensors, which take the plain versions.
`nn_dir_plain` is held against the Pallas kernel `_nn_direction_pallas` in
interpret mode, `nn_parts_plain` against `_nn_parts_ref` (what
`_nn_parts_pallas` runs off the TPU), the public functions against their
JAX counterparts (the jnp route on the CPU).

Tolerances: distances atol 1e-5, rtol 1e-5 (JAX forms |x|^2 + |y|^2 - 2x.y
from a matmul, the port (dx^2 + dy^2) + dz^2; the rtol covers the sqrt
option on small distances); gradients atol 1e-4, rtol 1e-4.  Witnesses are
equal, except where the two are near ties: where the distance to the JAX
witness, computed the port's way, exceeds the port's minimum by at most
1e-5 either index is accepted.  Losses atol 1e-6 against JAX, and the
golden (`tests/golden/reference_values.npz`) at atol 1e-5, rtol 1e-4, as
tests/test_golden.py holds the JAX package.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_part_assembly_tpu.ops import chamfer as JC
from multi_part_assembly_tpu.utils import loss as JL
from multi_part_assembly_tpu_torch.ops import chamfer as TC
from multi_part_assembly_tpu_torch.utils import loss as TL
from multi_part_assembly_tpu_torch.utils import tracing

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'reference_values.npz')
DIST_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
TIE = 1e-5


def _sq(a, b):
    """The port's distance expression on numpy arrays [..., 3]."""
    dx, dy, dz = np.moveaxis(a - b, -1, 0)
    return (dx * dx + dy * dy) + dz * dz


def _check_witnesses(x, y, ours_idx, ours_dist, ref_idx):
    """x [M, 3] queries, y [K, 3] targets, indices [M] into y: equal, or a
    near tie of the port's minimum."""
    differ = ours_idx != ref_idx
    gap = _sq(x, y[ref_idx]) - ours_dist
    assert (gap >= -1e-7).all()  # the port's minimum is the minimum
    assert (gap[differ] <= TIE).all(), gap[differ].max()
    assert differ.mean() < 0.01


# (B, N1, N2): N2 > 1024 gives the JAX kernel two y chunks and a padded
# tail, with N1 not a multiple of 128; N1 != N2 both ways; tiny clouds
DIR_CASES = {'two_chunks': (2, 130, 1500), 'n1_gt_n2': (2, 300, 200),
             'tiny': (3, 7, 5)}


def _clouds(shape1, shape2, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return (scale * rng.randn(*shape1)).astype(np.float32), \
        (scale * rng.randn(*shape2)).astype(np.float32)


@pytest.mark.parametrize('case', sorted(DIR_CASES))
def test_nn_dir_plain_matches_pallas(case):
    B, N1, N2 = DIR_CASES[case]
    x, y = _clouds((B, N1, 3), (B, N2, 3))
    rd, ri = (np.asarray(v) for v in JC._nn_direction_pallas(
        jnp.asarray(x), jnp.asarray(y), interpret=True))
    od, oi = (v.numpy() for v in TC.nn_dir_plain(torch.tensor(x),
                                                  torch.tensor(y)))
    assert od.shape == (B, N1) and oi.dtype == np.int32
    np.testing.assert_allclose(od, rd, **DIST_TOL)
    for b in range(B):
        _check_witnesses(x[b], y[b], oi[b], od[b], ri[b])


def test_nn_dir_plain_blocks_agree(monkeypatch):
    """Blocking the plain version by clouds and rows changes nothing."""
    x, y = _clouds((5, 33, 3), (5, 21, 3), seed=1)
    whole = TC.nn_dir_plain(torch.tensor(x), torch.tensor(y))
    monkeypatch.setattr(TC, '_PLAIN_PAIRS', 50)  # 2 rows, 1 cloud a block
    blocked = TC.nn_dir_plain(torch.tensor(x), torch.tensor(y))
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


# (P, N, part counts); N = 130 gives Npad = 256
PARTS_CASES = {'mixed': (5, 40, [2, 5, 3, 0]), 'single': (4, 40, [1, 1]),
               'npad_256': (3, 130, [3, 2])}


@pytest.mark.parametrize('case', sorted(PARTS_CASES))
def test_nn_parts_plain_matches_jax_ref(case):
    P, N, counts = PARTS_CASES[case]
    B = len(counts)
    x, y = _clouds((B, P, N, 3), (B, P, N, 3), seed=2)
    n = np.asarray(counts, np.int32)
    npad = -(-N // 128) * 128
    rd, ri = (np.asarray(v) for v in JC._nn_parts_ref(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(n), npad))
    od, oi = (v.numpy() for v in TC.nn_parts_plain(
        torch.tensor(x), torch.tensor(y), torch.tensor(n)))
    np.testing.assert_allclose(od, rd, **DIST_TOL)
    for b, c in enumerate(counts):
        assert (od[b, c:] == 0).all() and (oi[b, c:] == 0).all()
        assert (ri[b, c:] == 0).all()
        if c == 0:
            continue
        # JAX numbering part * npad + local -> the [c * N] valid targets
        flat = lambda i: (i // npad) * N + i % npad  # noqa: E731
        _check_witnesses(x[b, :c].reshape(-1, 3), y[b, :c].reshape(-1, 3),
                         flat(oi[b, :c].reshape(-1)),
                         od[b, :c].reshape(-1), flat(ri[b, :c].reshape(-1)))


def test_nn_parts_plain_is_nn_plain_renumbered():
    """Distances equal the fused route's plain version bit for bit, and the
    witnesses name the same point."""
    P, N, counts = PARTS_CASES['npad_256']
    x, y = (torch.tensor(v) for v in _clouds((2, P, N, 3), (2, P, N, 3)))
    n = torch.tensor(counts, dtype=torch.int32)
    d_off, i_off = TC.nn_parts_plain(x, y, n)
    d_fused, w_fused = TC.nn_plain(x, y, n, diagonal=False)
    assert torch.equal(d_off, d_fused)
    valid = w_fused >= 0
    assert torch.equal((i_off // 256 * N + i_off % 256)[valid],
                       w_fused[valid])


# chamfer_distance options: (transpose, sqrt, 2-D input)
API_CASES = {'plain': (False, False, False), 'transpose': (True, False, False),
             'sqrt': (False, True, False), 'two_d': (False, False, True),
             'transpose_sqrt': (True, True, False)}


def _api_inputs(transpose, two_d, seed=3):
    shape1, shape2 = ((1, 70, 3), (1, 90, 3)) if two_d else \
        ((3, 70, 3), (3, 90, 3))
    x, y = _clouds(shape1, shape2, seed=seed)
    if transpose:
        x, y = np.swapaxes(x, 1, 2).copy(), np.swapaxes(y, 1, 2).copy()
    if two_d:
        x, y = x[0], y[0]
    rng = np.random.RandomState(seed + 1)
    c1 = rng.rand(x.shape[-2] if not transpose else x.shape[-1])
    c2 = rng.rand(y.shape[-2] if not transpose else y.shape[-1])
    return x, y, c1.astype(np.float32), c2.astype(np.float32)


@pytest.mark.parametrize('case', sorted(API_CASES))
def test_chamfer_distance_matches_jax(case):
    transpose, sqrt, two_d = API_CASES[case]
    x, y, c1, c2 = _api_inputs(transpose, two_d)
    kw = dict(transpose=transpose, sqrt=sqrt)

    def jax_loss(a, b):
        d1, d2 = JC.chamfer_distance(a, b, **kw)
        return jnp.sum(d1 * c1) + jnp.sum(d2 * c2)

    rd = [np.asarray(v) for v in JC.chamfer_distance(x, y, **kw)]
    rg = [np.asarray(v) for v in jax.grad(jax_loss, (0, 1))(x, y)]
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    od = TC.chamfer_distance(xt, yt, **kw)
    ((od[0] * torch.tensor(c1)).sum() + (od[1] * torch.tensor(c2)).sum()
     ).backward()
    for r, o in zip(rd, od):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.detach().numpy(), r, **DIST_TOL)
    for r, o in zip(rg, (xt.grad, yt.grad)):
        np.testing.assert_allclose(o.numpy(), r, **GRAD_TOL)
    assert not any(k.startswith('launch.') for k in tracing.counters())


@pytest.mark.parametrize('sqrt', [False, True])
def test_nn_distance_matches_jax(sqrt):
    x, y, c1, c2 = _api_inputs(False, False, seed=5)

    def jax_loss(a, b):
        d1, _, d2, _ = JC.nn_distance(a, b, sqrt=sqrt)
        return jnp.sum(d1 * c1) + jnp.sum(d2 * c2)

    rd1, ri1, rd2, ri2 = (np.asarray(v) for v in
                          JC.nn_distance(x, y, sqrt=sqrt))
    rg = [np.asarray(v) for v in jax.grad(jax_loss, (0, 1))(x, y)]
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    od1, oi1, od2, oi2 = TC.nn_distance(xt, yt, sqrt=sqrt)
    ((od1 * torch.tensor(c1)).sum() + (od2 * torch.tensor(c2)).sum()
     ).backward()
    np.testing.assert_allclose(od1.detach().numpy(), rd1, **DIST_TOL)
    np.testing.assert_allclose(od2.detach().numpy(), rd2, **DIST_TOL)
    plain1, _, plain2, _ = TC.nn_distance(xt.detach(), yt.detach())
    for b in range(x.shape[0]):
        _check_witnesses(x[b], y[b], oi1[b].numpy(), plain1[b].numpy(),
                         ri1[b])
        _check_witnesses(y[b], x[b], oi2[b].numpy(), plain2[b].numpy(),
                         ri2[b])
    for r, o in zip(rg, (xt.grad, yt.grad)):
        np.testing.assert_allclose(o.numpy(), r, **GRAD_TOL)


def test_chamfer_distance_ref_matches_plain():
    """The naive full-matrix version equals the blocked plain one."""
    x, y = (torch.tensor(v) for v in _clouds((2, 50, 3), (2, 80, 3), seed=6))
    d1, i1, d2, i2 = TC.chamfer_distance_ref(x, y)
    for ref, ours in zip((d1, i1, d2, i2),
                         TC.nn_distance(x, y)):
        assert torch.equal(ref, ours)


def test_chamfer_distance_first_hit_tie():
    """Two targets at the same distance: the first one takes the whole
    gradient."""
    x = torch.tensor([[[0.0, 0.0, 0.0]]], requires_grad=True)
    y = torch.tensor([[[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]]],
                     requires_grad=True)
    d1, i1, _, _ = TC.nn_distance(x, y)
    assert int(i1[0, 0]) == 0 and float(d1.detach()[0, 0]) == 1.0
    d1.sum().backward()
    np.testing.assert_array_equal(y.grad.numpy()[0],
                                  [[2.0, 0, 0], [0, 0, 0]])


def _rep_inputs(seed=7, B=3, P=4, N=24):
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-0.05, 0.05, (B, P, 1, 3))
    pts = (centres + 0.05 * rng.randn(B, P, N, 3)).astype(np.float32)
    valids = (np.arange(P)[None] <
              np.asarray([2, 4, 3])[:B, None]).astype(np.float32)
    return pts, valids


@pytest.mark.parametrize('dense_limit', [2**27, 0], ids=['dense', 'scan'])
def test_repulsion_cd_loss_matches_jax(dense_limit):
    pts, valids = _rep_inputs()
    thre = 0.01

    def jax_loss(p):
        return jnp.sum(JL.repulsion_cd_loss(p, jnp.asarray(valids), thre,
                                            dense_limit=dense_limit))

    ref = np.asarray(JL.repulsion_cd_loss(jnp.asarray(pts),
                                          jnp.asarray(valids), thre,
                                          dense_limit=dense_limit))
    ref_grad = np.asarray(jax.grad(jax_loss)(jnp.asarray(pts)))
    pt = torch.tensor(pts, requires_grad=True)
    ours = TL.repulsion_cd_loss(pt, torch.tensor(valids), thre,
                                dense_limit=dense_limit)
    ours.sum().backward()
    assert 0.0 < ref.min()  # some pairs lie inside the threshold
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(pt.grad.numpy(), ref_grad, **GRAD_TOL)


def test_repulsion_routes_agree():
    """The dense call and the per-part loop give the same cd matrix."""
    pts, _ = _rep_inputs(seed=8)
    dense = TL.repulsion_cd_matrix(torch.tensor(pts))
    scan = TL.repulsion_cd_matrix(torch.tensor(pts), dense_limit=0)
    torch.testing.assert_close(scan, dense, atol=0, rtol=1e-6)


@pytest.mark.parametrize('dense_limit', [2**27, 0], ids=['dense', 'scan'])
def test_repulsion_cd_loss_golden(dense_limit):
    g = np.load(GOLDEN)
    ours = TL.repulsion_cd_loss(torch.tensor(g['pts']),
                                torch.tensor(g['valids']), thre=0.01,
                                dense_limit=dense_limit)
    np.testing.assert_allclose(ours.numpy(), g['repulsion_cd_loss'],
                               atol=1e-5, rtol=1e-4)


def test_set_fused_mode_refuses_unknown_words():
    with pytest.raises(ValueError, match='fused mode'):
        TC.set_fused_mode('on')
    assert TC.fused_mode() == 'auto'


@pytest.mark.parametrize('word,expected', [('off', 'off'), ('force', 'force'),
                                           ('maybe', 'ValueError')])
def test_fused_mode_read_from_environment(word, expected):
    code = ('from multi_part_assembly_tpu_torch.ops import chamfer as C; '
            'print(C.fused_mode())')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, 'MPA_CHAMFER_FUSED': word})
    if expected == 'ValueError':
        assert proc.returncode != 0 and 'ValueError' in proc.stderr
    else:
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == expected


def test_new_kernel_wrappers_refuse_cpu_tensors():
    """B7 and B8 never fall back: a CPU tensor is refused."""
    x = torch.zeros((1, 2, 4, 3))
    with pytest.raises(ValueError, match='CUDA'):
        TC.nn_parts_cuda(x, x, torch.tensor([2], dtype=torch.int32))
    with pytest.raises(ValueError, match='CUDA'):
        TC.nn_dir_cuda(x[0], x[0])


def test_unsupported_device_raises():
    x = torch.zeros((1, 4, 3), device='meta')
    with pytest.raises(ValueError, match='no chamfer kernel'):
        TC.chamfer_distance(x, x)
