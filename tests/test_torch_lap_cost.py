"""Kernel L2 (ops/matching.py `lap_cost_cuda`, csrc/matching.cu), the
semantic matching's block-masked LAP cost, on a card.

Every test needs a CUDA device and skips without one.  The file imports no
JAX, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_lap_cost.py --noconftest -q

L2 is held against the plain path, `lap_cost(_pair_chamfer_cost(a, b),
match_ids)`, and against the same cost in f64 with `torch.cdist` (direct
differences, as the benchmark's reference computes it).  Tolerances:
  - in-group entries within F64_RTOL (2e-6) relative of the f64 cost: a
    distance of direct differences takes about five roundings of 2^-24,
    the minimum none, the tree sum of at most 256 positive terms and the
    quotient by n a few more;
  - in-group entries within PLAIN_RTOL * |plain| + PLAIN_ATOL * R2 of the
    plain f32 path, R2 the largest squared norm of a point of the batch:
    the plain path's expanded form x2 + y2 - 2 x.y rounds each of its
    three terms at the scale of R2 before they cancel;
  - every other entry exactly 1e9 (outside a group) or 0 (the diagonal of
    an ungrouped row, padded parts included), as the plain path's;
  - two launches, and a CUDA graph's replay against the eager launch, bit
    for bit (a fixed summation order, no atomics);
  - L1 on L2's cost: the plain cost's assignment wherever the optimum of
    every group, enumerated on the f64 cost, beats the next permutation by
    more than MARGIN (the CPU test's margin, tests/test_torch_matching.py);
    and everywhere an objective within LAP_RTOL of scipy's optimum on the
    same cost (chip_smoke.py's LAP_RTOL).
"""

import itertools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from multi_part_assembly_tpu_torch.ops import \
    matching as TM  # noqa: E402
from multi_part_assembly_tpu_torch.utils import tracing  # noqa: E402
from multi_part_assembly_tpu_torch.utils.transforms import \
    transform_pc  # noqa: E402

F64_RTOL = 2e-6
PLAIN_RTOL, PLAIN_ATOL = 1e-6, 2e-6
MARGIN = 1e-4
LAP_RTOL = 1e-6
BIG = 1e9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _chair_ids(rng, B, P, min_parts=2):
    """match_ids [B, P] as the synthetic chair set draws them
    (benchmark/harness/synth.py `generate_partnet`, numbered as
    datasets/partnet.py numbers them): 2..P parts, about a third of them
    sharing a class with another part; a class of two or more parts is a
    group, the rest and the padding 0.  Also the part counts."""
    ids = np.zeros((B, P), np.int32)
    counts = rng.integers(min_parts, P + 1, B)
    for s, n in enumerate(counts):
        n_classes = max(1, n - n // 3)
        geo = np.concatenate([np.arange(1, n_classes + 1),
                              rng.integers(1, n_classes + 1,
                                           n - n_classes)])[:n]
        group = 1
        for g in range(1, n_classes + 1):
            idx = np.where(geo == g)[0]
            if len(idx) > 1:
                ids[s, idx] = group
                group += 1
    return ids, counts


def _groups(kind, rng, B, P):
    """(match_ids [B, P] int32, part counts [B]): 'singletons' (each part a
    group of its own, numbered 1..P), 'one' (every part in one group),
    'chair' (the synthetic chair's draws) or 'padded' (half the slots
    padding, the valid parts in pairs and one ungrouped part)."""
    if kind == 'singletons':
        return np.tile(np.arange(1, P + 1, dtype=np.int32), (B, 1)), \
            np.full(B, P)
    if kind == 'one':
        return np.ones((B, P), np.int32), np.full(B, P)
    if kind == 'chair':
        return _chair_ids(rng, B, P)
    valid = max(1, P // 2)
    ids = np.zeros((B, P), np.int32)
    ids[:, :valid - 1] = np.arange(valid - 1) // 2 + 1
    return ids, np.full(B, valid)


def _clouds(kind, rng, B, P, n, counts):
    """a, b [B, P, n, 3] f32: a part's subsample moved by a predicted and by
    a true pose.  'random': 0.1-scale parts around centres in
    [-0.4, 0.4]^3, b a jittered copy; 'overlap': every centre at 0;
    'collapsed': each part of b shrunk to its first point.  Padded parts'
    clouds are 0 in both, as the data leaves them."""
    base = rng.uniform(-0.05, 0.05, (B, P, n, 3))
    centre = 0.0 if kind == 'overlap' else \
        rng.uniform(-0.4, 0.4, (B, P, 1, 3))
    a = base + centre
    b = base + centre + rng.uniform(-0.02, 0.02, (B, P, 1, 3)) + \
        0.01 * rng.standard_normal((B, P, n, 3))
    if kind == 'collapsed':
        b = np.repeat(b[:, :, :1], n, axis=2)
    pad = np.arange(P)[None] >= np.asarray(counts)[:, None]
    a[pad] = 0.0
    b[pad] = 0.0
    return a.astype(np.float32), b.astype(np.float32)


def _f64_cost(a, b, ids):
    a, b = a.double(), b.double()
    d = torch.cdist(a[:, :, None], b[:, None],
                    compute_mode='donot_use_mm_for_euclid_dist') ** 2
    return TM.lap_cost(d.amin(4).mean(3) + d.amin(3).mean(3), ids)


def _in_group(ids):
    return (ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] > 0)


def _case(cuda, clouds, groups, n, P, B=3, seed=0):
    rng = np.random.default_rng(seed)
    ids, counts = _groups(groups, rng, B, P)
    a, b = _clouds(clouds, rng, B, P, n, counts)
    return [torch.tensor(v, device=cuda) for v in (a, b, ids)]


@pytest.mark.cuda
@pytest.mark.parametrize('groups', ['singletons', 'one', 'chair', 'padded'])
@pytest.mark.parametrize('clouds', ['random', 'overlap', 'collapsed'])
@pytest.mark.parametrize('n,P', [(100, 20), (37, 20), (100, 5), (37, 32)])
def test_lap_cost_kernel_matches_plain_and_f64(cuda, clouds, groups, n, P):
    """In-group entries against the f64 cost and the plain f32 path, every
    other entry exactly the plain path's constant; a second launch bitwise
    the first; one launch counted a call."""
    a, b, ids = _case(cuda, clouds, groups, n, P, seed=n + P)
    tracing.reset()
    got = TM.lap_cost_cuda(a, b, ids)
    again = TM.lap_cost_cuda(a, b, ids)
    torch.cuda.synchronize()
    assert tracing.counters().get('launch.lap_cost') == 2
    assert got.dtype == torch.float32 and got.shape == (a.shape[0], P, P)
    assert torch.equal(got, again)
    plain = TM.lap_cost(TM._pair_chamfer_cost(a, b), ids)
    ref = _f64_cost(a, b, ids)
    inb = _in_group(ids)
    assert inb.any()
    assert torch.equal(got[~inb], plain[~inb])
    assert set(got[~inb].unique().tolist()) <= {0.0, BIG}
    k, p, r = got[inb].double(), plain[inb].double(), ref[inb]
    assert bool(torch.isfinite(k).all())
    assert bool(((k - r).abs() <= F64_RTOL * r.abs()).all()), \
        float(((k - r).abs() / r.abs()).max())
    r2 = float(torch.stack([a, b]).square().sum(-1).max())
    assert bool(((k - p).abs() <= PLAIN_RTOL * p.abs()
                 + PLAIN_ATOL * r2).all()), float((k - p).abs().max())


def _objective(cost, perm):
    return cost.gather(2, perm.long()[..., None]).sum((1, 2))


def _unique_optimum(ref, ids):
    """[B] bool: each group's best permutation on the f64 cost beats its
    next by more than MARGIN (groups enumerated; at most 6 parts)."""
    out = []
    for c, row in zip(ref.cpu().numpy(), ids.cpu().numpy()):
        ok = True
        for g in set(row[row > 0].tolist()):
            rows = np.where(row == g)[0]
            if len(rows) > 6:
                ok = False
                continue
            sub = c[np.ix_(rows, rows)]
            objs = sorted(sub[np.arange(len(rows)), list(q)].sum()
                          for q in itertools.permutations(range(len(rows))))
            ok &= len(objs) < 2 or objs[1] - objs[0] > MARGIN
        out.append(ok)
    return torch.tensor(out)


@pytest.mark.cuda
@pytest.mark.parametrize('clouds', ['random', 'overlap', 'collapsed'])
def test_lap_on_kernel_cost_gives_the_plain_assignment(cuda, clouds):
    """L1 on L2's cost of 32 chair shapes at n = 100: the plain cost's
    assignment wherever the optimum is unique by MARGIN, and scipy's
    objective within LAP_RTOL everywhere."""
    a, b, ids = _case(cuda, clouds, 'chair', 100, 20, B=32, seed=5)
    got = TM.lap_cost_cuda(a, b, ids)
    plain = TM.lap_cost(TM._pair_chamfer_cost(a, b), ids)
    perm = TM.solve_lap(got)
    perm_plain = TM.solve_lap(plain)
    unique = _unique_optimum(_f64_cost(a, b, ids), ids).to(cuda)
    assert unique.any()
    same = (perm == perm_plain).all(-1)
    assert bool(same[unique].all())
    cost = got.double().cpu()
    best = _objective(cost, torch.from_numpy(
        TM.hungarian_scipy(got.cpu().numpy())))
    mine = _objective(cost, perm.cpu())
    assert bool(((mine - best).abs()
                 <= LAP_RTOL * best.abs().clamp(min=1e-12)).all())


@pytest.mark.cuda
def test_lap_cost_kernel_replays_in_a_cuda_graph(cuda):
    """A launch captured in a CUDA graph and replayed gives the eager
    launch's bits, on new inputs copied into the captured ones; the capture
    counts one launch and a replay none."""
    a, b, ids = _case(cuda, 'random', 'chair', 100, 20, B=32, seed=1)
    a2, b2, _ = _case(cuda, 'random', 'chair', 100, 20, B=32, seed=2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TM.lap_cost_cuda(a, b, ids)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    tracing.reset()
    with torch.cuda.graph(graph):
        out = TM.lap_cost_cuda(a, b, ids)
    assert tracing.counters().get('launch.lap_cost') == 1
    a.copy_(a2)
    b.copy_(b2)
    graph.replay()
    torch.cuda.synchronize()
    assert tracing.counters().get('launch.lap_cost') == 1
    assert torch.equal(out, TM.lap_cost_cuda(a2, b2, ids))


@pytest.mark.cuda
def test_lap_cost_kernel_refusals(cuda):
    """n above 256 (or 0), another dtype, a CPU or non-contiguous tensor
    raise before any launch; an empty batch launches nothing."""
    a, b, ids = _case(cuda, 'random', 'chair', 37, 5, B=2)
    tracing.reset()
    big = torch.zeros((1, 2, 257, 3), device=cuda)
    with pytest.raises(ValueError, match='n <= 256'):
        TM.lap_cost_cuda(big, big, torch.ones((1, 2), dtype=torch.int32,
                                              device=cuda))
    with pytest.raises(ValueError, match='float32'):
        TM.lap_cost_cuda(a.double(), b, ids)
    with pytest.raises(ValueError, match='float32'):
        TM.lap_cost_cuda(a, b.half(), ids)
    with pytest.raises(ValueError, match='int32'):
        TM.lap_cost_cuda(a, b, ids.long())
    with pytest.raises(ValueError, match='CUDA'):
        TM.lap_cost_cuda(a.cpu(), b.cpu(), ids.cpu())
    with pytest.raises(ValueError, match='contiguous'):
        TM.lap_cost_cuda(a.transpose(0, 1).contiguous().transpose(0, 1),
                         b, ids)
    assert 'launch.lap_cost' not in tracing.counters()
    empty = TM.lap_cost_cuda(a[:0], b[:0], ids[:0])
    assert empty.shape == (0, 5, 5)
    assert 'launch.lap_cost' not in tracing.counters()


@pytest.mark.cuda
def test_match_parts_on_the_card_launches_the_kernels(cuda):
    """match_parts on CUDA tensors launches L2 once and L1 once and gives
    the CPU's permuted poses wherever the optimum is unique by MARGIN."""
    rng = np.random.default_rng(7)
    B, P, N = 8, 20, 300
    ids, counts = _chair_ids(rng, B, P)
    pcs = rng.uniform(-0.05, 0.05, (B, P, N, 3))
    pcs[np.arange(P)[None] >= counts[:, None]] = 0.0
    q = rng.standard_normal((2, B, P, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.uniform(-0.4, 0.4, (2, B, P, 3))
    args = [torch.tensor(v.astype(np.float32)) for v in
            (pcs, t[0], q[0], t[1], q[1], ids)]
    idx = torch.randperm(N, generator=torch.Generator().manual_seed(0))[:100]
    cpu = TM.match_parts(*args, 'quat', sample_idx=idx)
    tracing.reset()
    card = TM.match_parts(*[v.to(cuda) for v in args], 'quat',
                          sample_idx=idx)
    c = tracing.counters()
    assert c.get('launch.lap_cost') == 1 and c.get('launch.lap') == 1
    pts = args[0][:, :, idx]
    moved = [transform_pc(args[k], args[k + 1], pts, rot_type='quat')
             for k in (1, 3)]
    unique = _unique_optimum(_f64_cost(*moved, args[5]), args[5])
    assert unique.any()
    for x, y in zip(card, cpu):
        assert torch.equal(x.cpu()[unique], y[unique])
