"""The port's PointNet++ sampling ops (ops/sampling.py) against the JAX
package's.

The same numpy inputs from a seed go through both, in f32.  Tolerances:
  - `furthest_point_sample` and `ball_query`: indices exactly equal, on
    clouds with padded (all-zero) points, an all-padded cloud, and balls
    that hold no point, one point, or more than `nsample`;
  - `gather_points`, `group_points`: exactly; `three_nn`'s indices exactly
    and its distances, `three_interpolate` and the gathers' gradients
    within 1e-6 relative to the larger of 1 and the reference's largest
    magnitude.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_part_assembly_tpu_torch.ops import sampling as TS

JS = importlib.import_module('multi_part_assembly_tpu.ops.sampling')

torch.set_num_threads(2)


def _close(a, b, tol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = float(np.abs(a - b).max())
    assert err <= tol * max(1.0, float(np.abs(b).max())), err


def _clouds(seed, B=4, N=300):
    """Clouds in [-1, 1]^3; cloud 1 has its last 100 points padded (zeros),
    cloud 2 is all padding, cloud 3 has a duplicated block (FPS ties)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    x[1, -100:] = 0.0
    x[2] = 0.0
    x[3, 150:] = x[3, :150]
    return x


@pytest.mark.parametrize('npoint', [1, 64, 200])
def test_furthest_point_sample_matches_jax(npoint):
    x = _clouds(0)
    ref = np.asarray(JS.furthest_point_sample(jnp.asarray(x), npoint))
    ours = TS.furthest_point_sample(torch.tensor(x), npoint).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ours[:, 0] == 0).all() and (ours[2] == 0).all()
    if npoint > 1:  # padded points are never picked after the start
        assert (ours[1, 1:] < 200).all()


@pytest.mark.parametrize('radius,nsample', [(0.05, 8), (0.2, 16),
                                            (0.4, 64), (3.5, 32)])
def test_ball_query_matches_jax(radius, nsample):
    x = _clouds(1)
    centres = x[:, ::5].copy()
    centres[0, :4] = 5.0  # far outside: empty balls
    ref = np.asarray(JS.ball_query(radius, nsample, jnp.asarray(x),
                                   jnp.asarray(centres)))
    ours = TS.ball_query(radius, nsample, torch.tensor(x),
                         torch.tensor(centres)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ours[0, :4] == 0).all()
    # ascending first hits, backfilled with the first
    row = ours[0, 10]
    first = row[0]
    n_hit = int((row != first).sum()) + 1
    assert (np.diff(row[:n_hit]) > 0).all() and (row[n_hit:] == first).all()


def test_gathers_and_their_gradients_match_jax():
    rng = np.random.RandomState(2)
    pts = rng.randn(2, 50, 6).astype(np.float32)
    idx2 = rng.randint(0, 50, (2, 20)).astype(np.int32)
    idx3 = rng.randint(0, 50, (2, 20, 8)).astype(np.int32)
    pt = torch.tensor(pts)
    np.testing.assert_array_equal(
        TS.gather_points(pt, torch.tensor(idx2).long()).numpy(),
        np.asarray(JS.gather_points(jnp.asarray(pts), jnp.asarray(idx2))))
    np.testing.assert_array_equal(
        TS.group_points(pt, torch.tensor(idx3).long()).numpy(),
        np.asarray(JS.group_points(jnp.asarray(pts), jnp.asarray(idx3))))
    cot = rng.randn(2, 20, 8, 6).astype(np.float32)
    ref = jax.grad(lambda p: jnp.sum(JS.group_points(p, jnp.asarray(idx3))
                                     * cot))(jnp.asarray(pts))
    pg = pt.clone().requires_grad_(True)
    (TS.group_points(pg, torch.tensor(idx3).long()) *
     torch.tensor(cot)).sum().backward()
    _close(pg.grad.numpy(), np.asarray(ref))


def test_three_nn_and_interpolate_match_jax():
    rng = np.random.RandomState(3)
    unknown = rng.randn(2, 40, 3).astype(np.float32)
    known = rng.randn(2, 12, 3).astype(np.float32)
    feats = rng.randn(2, 12, 5).astype(np.float32)
    d_ref, i_ref = JS.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    d, i = TS.three_nn(torch.tensor(unknown), torch.tensor(known))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    _close(d.numpy(), np.asarray(d_ref))
    w = rng.rand(2, 40, 3).astype(np.float32)
    _close(TS.three_interpolate(torch.tensor(feats), i,
                                torch.tensor(w)).numpy(),
           np.asarray(JS.three_interpolate(jnp.asarray(feats), i_ref,
                                           jnp.asarray(w))))


def test_sampling_override_and_record():
    x = torch.tensor(_clouds(4))
    fps = torch.arange(8).expand(4, 8).clone()
    TS.set_sampling_override(fps=[fps], record=True)
    try:
        assert torch.equal(TS.furthest_point_sample(x, 8), fps)
        computed = TS.furthest_point_sample(x, 8)
        ball = TS.ball_query(0.3, 4, x, x[:, :8])
        calls = TS.sampling_calls()
        assert [len(calls['fps']), len(calls['ball'])] == [2, 1]
        assert torch.equal(calls['fps'][1], computed)
        assert torch.equal(calls['ball'][0], ball)
    finally:
        TS.set_sampling_override()
    assert TS.sampling_calls() is None
