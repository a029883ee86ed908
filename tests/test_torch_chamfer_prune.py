"""Exact part-pair pruning of the port's whole-shape chamfer, and the packed
first-hit keys of its B1/B3 kernel, against the JAX package.

- The keep mask (`prune_keep_plain`) equals JAX `_forward_pairs(x, y,
  n_parts, P, 1)` decoded (one y-part a group), exactly, on spread,
  overlapping and mixed clouds.
- The plain forward restricted to the kept pairs equals the dense one bit
  for bit, witnesses included, ties too.
- `pack_keys` / min / `unpack_keys` follow the first-hit rule on exact ties
  whatever the merge order (exact equality).
- `chamfer_parts` and `chamfer_diag` (the port's dense list) match the JAX
  package with its pruning on and off (fused kernels in interpret mode)
  with the tolerances of test_torch_chamfer.py: distances atol 1e-5,
  gradients atol and rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_part_assembly_tpu.ops import chamfer as JC
from multi_part_assembly_tpu_torch.ops import chamfer as TC

torch.set_num_threads(2)

KINDS = ('spread', 'overlap', 'mixed', 'ties')


def _clouds(kind, seed=0, P=6, N=32, nparts=(6, 4, 1)):
    """Two part clouds [B, P, N, 3] and part counts.  'spread': 0.1-scale
    parts with centres over [-3, 3]^3 (most pairs prunable); 'overlap':
    every centre at 0 (nothing prunable); 'mixed': half the parts at 0, the
    rest spread; 'ties': mixed, with coordinates on a 1/64 grid and y a
    copy of x with some points duplicated."""
    rng = np.random.RandomState(seed)
    B = len(nparts)
    centres = rng.uniform(-3, 3, (B, P, 1, 3))
    if kind == 'overlap':
        centres[:] = 0.0
    elif kind in ('mixed', 'ties'):
        centres[:, ::2] = 0.0
    x = centres + 0.1 * rng.randn(B, P, N, 3)
    y = x + 0.02 * rng.randn(B, P, N, 3)
    if kind == 'ties':
        x = np.round(x * 64) / 64
        y = np.round(x * 64) / 64
        dup = np.arange(1, N, 4)  # duplicated points
        y[:, :, dup] = y[:, :, dup - 1]
        x[:, :, dup + 1] = x[:, :, dup]
    n_parts = np.asarray(nparts, np.int32)
    return x.astype(np.float32), y.astype(np.float32), n_parts


def _jax_keep(x, y, n_parts):
    """JAX `_forward_pairs` at gy = 1, decoded to a [B, P, P] bool mask."""
    B, P = x.shape[:2]
    rows = np.asarray(JC._forward_pairs(jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(n_parts), P, 1))
    keep = np.zeros((B, P * P), bool)
    for b in range(B):
        keep[b, rows[b, 2:2 + rows[b, 1]]] = True
    return keep.reshape(B, P, P)


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('kind', ['spread', 'overlap', 'mixed'])
def test_keep_mask_matches_jax(kind, seed):
    x, y, n_parts = _clouds(kind, seed)
    ours = TC.prune_keep_plain(torch.tensor(x), torch.tensor(y),
                               torch.tensor(n_parts)).numpy()
    np.testing.assert_array_equal(ours, _jax_keep(x, y, n_parts))
    dense = sum(int(n) ** 2 for n in n_parts)
    if kind == 'spread':
        assert ours.sum() < dense, 'nothing was pruned'
    if kind == 'overlap':
        assert ours.sum() == dense, 'overlapping parts were pruned'
    # every valid part keeps a pair in each direction
    for b, n in enumerate(n_parts):
        assert ours[b, :n, :n].any(1).all() and ours[b, :n, :n].any(0).all()


@pytest.mark.parametrize('kind', KINDS)
def test_pruned_plain_equals_dense(kind):
    x, y, n_parts = (torch.tensor(v) for v in _clouds(kind, 2))
    keep = TC.prune_keep_plain(x, y, n_parts)
    pruned = TC.nn_pair_plain(x, y, n_parts, False, keep)
    dense = TC.nn_pair_plain(x, y, n_parts, False)
    for p, d in zip(pruned, dense):
        assert torch.equal(p, d)


def test_packed_keys_first_hit_on_ties():
    """Minimum of packed keys = the smallest witness among equal minimal
    distances, whatever the merge order; unpack inverts pack."""
    rng = np.random.RandomState(3)
    d = torch.tensor(rng.randint(0, 4, (50, 16)) / 8.0, dtype=torch.float32)
    w = torch.tensor(rng.permutation(50 * 16).reshape(50, 16),
                     dtype=torch.int32)
    keys = TC.pack_keys(d, w)
    dist, witness = TC.unpack_keys(keys)
    assert torch.equal(dist, d) and torch.equal(witness, w)
    best_d = d.min(1, keepdim=True).values
    expect = torch.where(d == best_d, w, torch.iinfo(torch.int32).max).min(1)
    for perm in (torch.arange(16), torch.randperm(16),
                 torch.arange(15, -1, -1)):
        got_d, got_w = TC.unpack_keys(keys[:, perm].min(1).values)
        assert torch.equal(got_d, best_d[:, 0])
        assert torch.equal(got_w, expect.values)
    # padded parts' witness -1 packs below nothing of the same distance:
    # keys order as unsigned (distance, witness) pairs
    assert TC.pack_keys(torch.tensor([0.0]), torch.tensor([5])) < \
        TC.pack_keys(torch.tensor([0.0]), torch.tensor([-1]))
    assert TC.pack_keys(torch.tensor([1.0]), torch.tensor([-1])) < \
        TC.pack_keys(torch.tensor([1.5]), torch.tensor([0]))


@pytest.fixture(params=[True, False], ids=['prune', 'dense'])
def prune(request):
    JC.set_fused_mode('force')
    JC.set_prune_mode(request.param)
    yield request.param
    JC.set_fused_mode('auto')
    JC.set_prune_mode(True)


_JITTED = {}


def _jax(prune_on, name, x, y, valids, w1, w2):
    key = (prune_on, name)  # pruning is read when the function is traced
    if key not in _JITTED:
        fn = getattr(JC, name)

        def run(a, b, v, c1, c2):
            def loss(a, b):
                d1, d2 = fn(a, b, v)
                return jnp.sum(d1 * c1.reshape(d1.shape)) + \
                    jnp.sum(d2 * c2.reshape(d2.shape))
            return fn(a, b, v) + jax.grad(loss, (0, 1))(a, b)

        _JITTED[key] = jax.jit(run)
    return [np.asarray(v) for v in _JITTED[key](x, y, valids, w1, w2)]


@pytest.mark.parametrize('kind', ['spread', 'mixed'])
@pytest.mark.parametrize('name', ['chamfer_parts', 'chamfer_diag'])
def test_distances_and_grads_match_jax_with_pruning(prune, kind, name):
    x, y, n_parts = _clouds(kind, 4)
    B, P, N, _ = x.shape
    valids = (np.arange(P)[None] < n_parts[:, None]).astype(np.float32)
    rng = np.random.RandomState(5)
    w1, w2 = rng.rand(2, B, P, N).astype(np.float32)
    ref = _jax(prune, name, x, y, valids, w1, w2)
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    d1, d2 = getattr(TC, name)(xt, yt, torch.tensor(valids))
    ((d1 * torch.tensor(w1).reshape(d1.shape)).sum() +
     (d2 * torch.tensor(w2).reshape(d2.shape)).sum()).backward()
    ours = [v.detach().numpy() for v in (d1, d2, xt.grad, yt.grad)]
    if prune and name == 'chamfer_parts':  # the pruned plain forward too
        n = torch.tensor(n_parts)
        keep = TC.prune_keep_plain(xt.detach(), yt.detach(), n)
        p1, p2, _, _ = TC.nn_pair_plain(xt.detach(), yt.detach(), n, False,
                                        keep)
        for r, o in zip(ref[:2], (p1, p2)):
            np.testing.assert_allclose(o.reshape(r.shape).numpy(), r,
                                       atol=1e-5, rtol=0)
    for r, o in zip(ref[:2], ours[:2]):
        np.testing.assert_allclose(o, r, atol=1e-5, rtol=0)
    for r, o in zip(ref[2:], ours[2:]):
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-4)
