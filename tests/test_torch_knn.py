"""The port's kNN / EdgeConv ops (ops/knn.py) against the JAX package's.

The same numpy inputs from a seed go through both, in f32.  Tolerances:
  - `knn`: the neighbour SETS equal JAX's (its own test compares sets,
    tests/test_ops.py:135-145: `torch.topk` promises no order among equal
    distances), and blocked query rows give exactly the unblocked indices;
  - `neighborhood_reduce`: max and min exactly; sum, sum of squares and the
    gradient within 1e-6 of JAX's and of a plain gather reference that
    holds the [B, N, K, C] tensor (the sums add in another order), the
    limit relative to the larger of 1 and the reference's largest
    magnitude (`_close`); on a tie, the max/min cotangent goes to the first
    winning slot in k order;
  - `gather_rows`, `get_graph_feature`: exactly; `scatter_rows` within
    1e-6 as `_close` counts it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_part_assembly_tpu_torch.ops import knn as TK

# the JAX ops package exports a function `knn` under the module's name
JK = importlib.import_module('multi_part_assembly_tpu.ops.knn')

torch.set_num_threads(2)


def _close(a, b, tol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = float(np.abs(a - b).max())
    assert err <= tol * max(1.0, float(np.abs(b).max())), err


def _x(seed, B=3, N=40, C=5):
    return np.random.RandomState(seed).randn(B, N, C).astype(np.float32)


def _sets(idx):
    return [[frozenset(r) for r in b] for b in np.asarray(idx).tolist()]


@pytest.mark.parametrize('C', [3, 16])
def test_knn_sets_match_jax_and_blocking_is_exact(C):
    x = _x(0, C=C)
    ref = JK.knn(jnp.asarray(x), 7)
    ours = TK.knn(torch.tensor(x), 7)
    assert ours.shape == (3, 40, 7)
    assert _sets(ours) == _sets(ref)
    for rows in (8, 20):
        assert torch.equal(TK.knn(torch.tensor(x), 7, rows_per_block=rows),
                           ours)
    # each row's own index is among its neighbours
    assert all(i in s for b in _sets(ours) for i, s in enumerate(b))


def test_knn_override_and_record():
    x = torch.tensor(_x(1))
    given = torch.zeros((3, 40, 4), dtype=torch.long)
    TK.set_knn_override([given], record=True)
    try:
        assert torch.equal(TK.knn(x, 4), given)
        computed = TK.knn(x, 4)
        assert not torch.equal(computed, given)
        calls = TK.knn_calls()
        assert len(calls) == 2 and torch.equal(calls[1], computed)
    finally:
        TK.set_knn_override()
    assert TK.knn_calls() is None


def _idx(seed, B=2, N=30, K=6):
    return np.random.RandomState(seed).randint(0, N, (B, N, K)).astype(
        np.int32)


def _plain_reduce(u, idx):
    """The reference shape: gather [B, N, K, C], then reduce over K."""
    B, N, K = idx.shape
    g = u[torch.arange(B)[:, None, None], idx]
    return g.amax(2), g.amin(2), g.sum(2), (g * g).sum(2)


def _cotangents(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _jax_reduce(u, idx, with_stats, cots):
    def f(u_):
        out = JK.neighborhood_reduce(u_, jnp.asarray(idx), with_stats)
        return sum(jnp.sum(o * c) for o, c in zip(out, cots)), out
    (_, out), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(u))
    return [np.asarray(o) for o in out], np.asarray(grad)


def _torch_reduce(fn, u, idx, cots):
    ut = torch.tensor(u, requires_grad=True)
    out = fn(ut, torch.tensor(idx).long())
    sum(((o * torch.tensor(c)).sum() for o, c in zip(out, cots)
         if o.requires_grad)).backward()
    return [o.detach().numpy() for o in out], ut.grad.numpy()


@pytest.mark.parametrize('with_stats', [True, False])
@pytest.mark.parametrize('kind', ['random', 'ties'])
def test_neighborhood_reduce_matches_jax_and_plain(with_stats, kind):
    rng = np.random.RandomState(3)
    u = rng.randn(2, 30, 8).astype(np.float32)
    if kind == 'ties':  # few distinct values: many equal maxima and minima
        u = np.round(u).astype(np.float32)
    idx = _idx(4)
    cots = _cotangents(5, u.shape)
    if not with_stats:  # s, q carry no gradient
        cots[2] = cots[3] = np.zeros_like(u)
    ref_out, ref_grad = _jax_reduce(u, idx, with_stats, cots)
    out, grad = _torch_reduce(
        lambda a, i: TK.neighborhood_reduce(a, i, with_stats), u, idx, cots)
    np.testing.assert_array_equal(out[0], ref_out[0])
    np.testing.assert_array_equal(out[1], ref_out[1])
    for o, r in zip(out[2:], ref_out[2:]):
        _close(o, r)
    _close(grad, ref_grad)
    if kind == 'random' and with_stats:  # no tie: autograd's routing agrees
        p_out, p_grad = _torch_reduce(_plain_reduce, u, idx, cots)
        for o, r in zip(out, p_out):
            _close(o, r)
        _close(grad, p_grad)


def test_neighborhood_reduce_first_winner_rule():
    """Row 0's neighbours are rows 1, 2, 3, all equal: the max and the min
    cotangent go to row 1, the first slot, and nowhere else."""
    u = np.zeros((1, 4, 1), np.float32)
    u[0, 0] = -5.0
    idx = np.array([[[1, 2, 3]] * 4], np.int32)
    cots = [np.ones_like(u), 2 * np.ones_like(u), np.zeros_like(u),
            np.zeros_like(u)]
    _, grad = _torch_reduce(
        lambda a, i: TK.neighborhood_reduce(a, i, False), u, idx, cots)
    # 4 rows, each sending 1 (max) + 2 (min) to its first slot, row 1
    np.testing.assert_array_equal(grad[0, :, 0], [0.0, 12.0, 0.0, 0.0])
    _, ref_grad = _jax_reduce(u, idx, False, cots)
    np.testing.assert_array_equal(grad, ref_grad)


def test_neighborhood_reduce_bf16_matches_jax():
    rng = np.random.RandomState(6)
    u = rng.randn(2, 30, 8).astype(np.float32)
    idx = _idx(7)
    ref = JK.neighborhood_reduce(jnp.asarray(u, jnp.bfloat16),
                                 jnp.asarray(idx), True)
    ours = TK.neighborhood_reduce(torch.tensor(u).bfloat16(),
                                  torch.tensor(idx).long(), True)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-6)


def test_gather_scatter_and_graph_feature_match_jax():
    x = _x(8, B=2, N=30, C=4)
    idx = np.random.RandomState(9).randint(0, 30, (2, 50)).astype(np.int32)
    np.testing.assert_array_equal(
        TK.gather_rows(torch.tensor(x), torch.tensor(idx).long()).numpy(),
        np.asarray(JK.gather_rows(jnp.asarray(x), jnp.asarray(idx))))
    y = np.random.RandomState(10).randn(2, 50, 4).astype(np.float32)
    _close(TK.scatter_rows(torch.tensor(y), torch.tensor(idx).long(),
                           30).numpy(),
           np.asarray(JK.scatter_rows(jnp.asarray(y), jnp.asarray(idx), 30)))
    k_idx = np.asarray(JK.knn(jnp.asarray(x), 5))
    np.testing.assert_array_equal(
        TK.get_graph_feature(torch.tensor(x), 5,
                             idx=torch.tensor(k_idx).long()).numpy(),
        np.asarray(JK.get_graph_feature(jnp.asarray(x), 5,
                                        idx=jnp.asarray(k_idx))))
