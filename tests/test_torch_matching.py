"""The port's assignment solver and part matching (ops/matching.py) against
the JAX package's.

The same numpy inputs from a seed go through both.  Tolerances:
  - `solve_lap_plain` against JAX `solve_lap`: bit for bit (the same
    arithmetic in the same order, ties to the first minimum), and optimal:
    its objective equals scipy's `linear_sum_assignment`'s within 1e-6
    relative (scipy may pick another optimum on a tie);
  - `_pair_chamfer_cost` within 1e-5 absolute: JAX packs bf16 splits into
    its cross term (about 2^-24 relative), the port computes it in f32;
  - `match_parts`, JAX's point subsample injected: the same permuted poses,
    exactly.  The inputs have no near-tie (two assignments whose costs
    differ by less than about 1e-5, where the two cost routes may pick
    differently): the test checks the gap first.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_part_assembly_tpu.ops import matching as JM
from multi_part_assembly_tpu.utils.rotation import Rotation3D as JRot
from multi_part_assembly_tpu_torch.ops import matching as TM
from multi_part_assembly_tpu_torch.utils.transforms import transform_pc

torch.set_num_threads(2)

SIZES = (1, 2, 3, 7, 20)
KINDS = ('random', 'ties', 'blocks')


def _cost(kind, n, seed, m=12):
    """[m, n, n] f32 costs: uniform, small integers (many ties), or
    match_parts' block mask over random groups (chamfer-like values within
    a group, 1e9 across, 0 on an ungrouped row's diagonal)."""
    rng = np.random.default_rng(seed)
    if kind == 'random':
        return rng.random((m, n, n)).astype(np.float32)
    if kind == 'ties':
        return rng.integers(0, 3, (m, n, n)).astype(np.float32)
    groups = rng.integers(0, max(2, n // 3), (m, n))
    base = (0.01 * rng.random((m, n, n))).astype(np.float32)
    return TM.lap_cost(torch.tensor(base), torch.tensor(groups)).numpy()


def _objective(cost, perm):
    return np.take_along_axis(cost, perm[..., None].astype(np.int64),
                              -1).sum((-1, -2))


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('n', SIZES)
def test_solve_lap_plain_equals_jax_and_is_optimal(kind, n):
    cost = _cost(kind, n, seed=n)
    ref = np.asarray(JM.solve_lap(jnp.asarray(cost)))
    ours = TM.solve_lap_plain(torch.tensor(cost))
    assert ours.dtype == torch.int32 and ours.shape == (12, n)
    np.testing.assert_array_equal(ours.numpy(), ref)
    # a permutation, at scipy's optimum
    assert (np.sort(ours.numpy(), -1) == np.arange(n)).all()
    best = _objective(cost.astype(np.float64),
                      TM.hungarian_scipy(cost))
    got = _objective(cost.astype(np.float64), ours.numpy())
    np.testing.assert_allclose(got, best, rtol=1e-6, atol=0)


def test_solve_lap_batch_shapes_and_cpu_route():
    """[..., n, n] in, [..., n] out; a CPU tensor takes the plain version
    (no launch counted); another device raises."""
    cost = _cost('random', 5, seed=3, m=6).reshape(2, 3, 5, 5)
    before = TM.LAUNCHES['lap']
    out = TM.solve_lap(torch.tensor(cost))
    assert out.shape == (2, 3, 5) and TM.LAUNCHES['lap'] == before
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(JM.solve_lap(jnp.asarray(cost))))
    with pytest.raises(ValueError, match='device'):
        TM.solve_lap(torch.zeros((1, 3, 3), device='meta'))


def test_pair_chamfer_cost_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(-0.5, 0.5, (3, 5, 40, 3)).astype(np.float32)
    b = (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
    ref = np.asarray(JM._pair_chamfer_cost(jnp.asarray(a), jnp.asarray(b)))
    ours = TM._pair_chamfer_cost(torch.tensor(a), torch.tensor(b)).numpy()
    assert ours.shape == (3, 5, 5)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def _match_inputs(rot_type, seed=5, B=4, P=7, N=150):
    """Clouds of random boxes, predicted and GT poses, groups of two or
    three equivalent parts, padding at the end of each shape."""
    rng = np.random.default_rng(seed)
    counts = [7, 5, 4, 6][:B]
    valids = (np.arange(P)[None] < np.asarray(counts)[:, None])
    pcs = rng.uniform(-0.5, 0.5, (B, P, N, 3)) * \
        rng.uniform(0.05, 0.3, (B, P, 1, 3))
    pcs = (pcs * valids[..., None, None]).astype(np.float32)
    match_ids = np.zeros((B, P), np.float32)
    match_ids[:, :3] = 1
    match_ids[:, 3] = 0
    match_ids[:, 4:6] = 2
    match_ids[~valids] = 0

    def quats():
        q = rng.standard_normal((B, P, 4))
        return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(
            np.float32)
    poses = {}
    for side in ('pred', 'gt'):
        t = rng.uniform(-0.4, 0.4, (B, P, 3)).astype(np.float32)
        q = quats()
        rot = q if rot_type == 'quat' else np.asarray(
            JRot(jnp.asarray(q), 'quat').convert('rmat').rot)
        poses[side] = (t, rot.astype(np.float32))
    return pcs, poses, match_ids


@pytest.mark.parametrize('rot_type', ['quat', 'rmat'])
def test_match_parts_matches_jax(rot_type):
    pcs, poses, match_ids = _match_inputs(rot_type)
    key = jax.random.PRNGKey(11)
    (pt, pr), (gt, gr) = poses['pred'], poses['gt']
    ref_t, ref_r = JM.match_parts(
        jnp.asarray(pcs), jnp.asarray(pt), jnp.asarray(pr), jnp.asarray(gt),
        jnp.asarray(gr), jnp.asarray(match_ids), key, rot_type)
    idx = np.asarray(jax.random.permutation(key, pcs.shape[2])[:100])

    # no near-tie: within each shape, the best assignment beats the next
    # best by far more than the two cost routes differ
    pts = torch.tensor(pcs)[:, :, torch.tensor(idx)]
    cost = TM._pair_chamfer_cost(
        transform_pc(torch.tensor(pt), torch.tensor(pr), pts,
                     rot_type=rot_type),
        transform_pc(torch.tensor(gt), torch.tensor(gr), pts,
                     rot_type=rot_type)).numpy()
    for b in range(cost.shape[0]):
        for g in (1, 2):
            rows = np.where(match_ids[b] == g)[0]
            sub = cost[b][np.ix_(rows, rows)].astype(np.float64)
            objs = sorted(sub[np.arange(len(rows)), list(p)].sum()
                          for p in itertools.permutations(range(len(rows))))
            if len(objs) > 1:
                assert objs[1] - objs[0] > 1e-4

    new_t, new_r = TM.match_parts(
        torch.tensor(pcs), torch.tensor(pt), torch.tensor(pr),
        torch.tensor(gt), torch.tensor(gr), torch.tensor(match_ids),
        rot_type, sample_idx=torch.tensor(idx))
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(new_r.numpy(), np.asarray(ref_r))
    # rows moved only within their group; ungrouped rows stay put
    moved = (new_t.numpy() != gt).any(-1)
    assert not moved[match_ids == 0].any()
    assert moved.any()


def test_match_parts_draws_its_subsample_from_the_generator():
    """Without an override, one generator seed gives one subsample (and
    so one answer), and the draw advances the generator."""
    pcs, poses, match_ids = _match_inputs('quat', seed=6)
    args = [torch.tensor(a) for a in (pcs, *poses['pred'], *poses['gt'],
                                      match_ids)]
    g = torch.Generator().manual_seed(0)
    first = TM.match_parts(*args, 'quat', generator=g)
    again = TM.match_parts(*args, 'quat',
                           generator=torch.Generator().manual_seed(0))
    idx = torch.randperm(pcs.shape[2],
                         generator=torch.Generator().manual_seed(0))[:100]
    fixed = TM.match_parts(*args, 'quat', sample_idx=idx)
    for a, b, c in zip(first, again, fixed):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(g.get_state(),
                           torch.Generator().manual_seed(0).get_state())


def test_hungarian_scipy_matches_jax_copy():
    cost = _cost('random', 6, seed=9)
    np.testing.assert_array_equal(TM.hungarian_scipy(cost),
                                  JM.hungarian_scipy(cost))
