"""Point-cloud sampling and grouping ops of PointNet++.

Port of multi_part_assembly_tpu/ops/sampling.py, itself a re-implementation
of the reference's `pointnet2_ops` CUDA extension.  None of these is a
Pallas kernel in the JAX package (they are XLA loops, gathers and top_k):
they are plain PyTorch here, on the card and on the CPU alike.  Channels-
last ([B, N, C]) throughout.

  - `furthest_point_sample(xyz, npoint)`: starts at index 0; a point with
    |p|^2 <= 1e-3 (padding) is never picked; ties go to the first maximum,
    as `jnp.argmax` (and `torch.argmax`) break them; an all-padded cloud
    gives all zeros.  A Python loop of npoint - 1 steps of a few launches
    each.
  - `ball_query(radius, nsample, xyz, new_xyz)`: the first `nsample`
    points with `d2 < radius^2` in f32, in ascending index order,
    backfilled with the first hit; an empty ball gives index 0.
  - `gather_points`, `group_points`, `three_nn`, `three_interpolate`.

The gathers are advanced indexing: their backward is
`index_put_(accumulate=True)`, which on the card sorts the indices and adds
in a fixed order.  Distances are exact f32 (no TF32).

`set_sampling_override(fps=[...], ball=[...])` hands FPS and ball query
their results, consumed in order, one a call, and `record=True` keeps
every call's result (`sampling_calls()`): a hook for tests that compare two
devices, where `d2 < r^2` or an FPS argmax can flip on an ulp.
"""

import torch

__all__ = ['furthest_point_sample', 'gather_points', 'ball_query',
           'group_points', 'three_nn', 'three_interpolate',
           'set_sampling_override', 'sampling_calls']

_OVERRIDE = {'fps': [], 'ball': []}
_CALLS = None


def set_sampling_override(fps=None, ball=None, record=False):
    """Give the next FPS / ball-query calls these index tensors (consumed
    in order), and/or start recording every call's result."""
    global _CALLS
    _OVERRIDE['fps'][:] = list(fps or [])
    _OVERRIDE['ball'][:] = list(ball or [])
    _CALLS = {'fps': [], 'ball': []} if record else None


def sampling_calls():
    return _CALLS


def _hooked(kind, device, compute):
    idx = _OVERRIDE[kind].pop(0).to(device) if _OVERRIDE[kind] \
        else compute()
    if _CALLS is not None:
        _CALLS[kind].append(idx.cpu())
    return idx


def _check_exact(x):
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError('sampling needs exact f32 matmuls: turn TF32 off')


def _sqdist(x, y):
    """[B, N, 3] x [B, M, 3] -> [B, N, M] squared distances in exact f32
    (JAX sampling.py:29-35), clamped at 0."""
    _check_exact(x)
    x2 = (x * x).sum(-1)
    y2 = (y * y).sum(-1)
    xy = torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp(x2[..., :, None] + y2[..., None, :] - 2 * xy, min=0.0)


def _rows(points, idx):
    """points [B, N, C], idx [B, M] -> [B, M, C] (advanced indexing)."""
    b = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return points[b, idx]


@torch.no_grad()
def _fps(xyz, npoint):
    B, N, _ = xyz.shape
    selectable = (xyz * xyz).sum(-1) > 1e-3
    idxs = torch.zeros((B, npoint), dtype=torch.long, device=xyz.device)
    min_d = torch.full((B, N), 1e10, device=xyz.device)
    last = torch.zeros((B, ), dtype=torch.long, device=xyz.device)
    neg = torch.full((), -1.0, device=xyz.device)
    for i in range(1, npoint):
        last_pt = xyz.gather(1, last[:, None, None].expand(B, 1, 3))
        d = ((xyz - last_pt)**2).sum(-1)  # [B, N]
        torch.minimum(min_d, d, out=min_d)
        last = torch.where(selectable, min_d, neg).argmax(-1)
        idxs[:, i] = last
    return idxs


def furthest_point_sample(xyz, npoint):
    """xyz [B, N, 3] f32 -> [B, npoint] int64 iterative furthest point
    sample (JAX sampling.py:38-72)."""
    with torch.profiler.record_function('furthest_point_sample'):
        return _hooked('fps', xyz.device,
                       lambda: _fps(xyz.float(), npoint))


def gather_points(points, idx):
    """out[b, m, c] = points[b, idx[b, m], c]."""
    return _rows(points, idx)


@torch.no_grad()
def _ball_query(radius, nsample, xyz, new_xyz):
    N = xyz.shape[1]
    in_ball = _sqdist(new_xyz, xyz) < radius * radius  # [B, M, N]
    ar = torch.arange(N, dtype=torch.int32, device=xyz.device)
    cand = torch.where(in_ball, ar, N)
    # the nsample smallest indices of the hits, ascending (the CUDA
    # kernel scans j upwards); N marks a miss
    hits = torch.topk(cand, nsample, dim=-1, largest=False).values
    hits = torch.where(hits < N, hits, hits[..., :1])  # first-hit backfill
    return torch.where(hits < N, hits, 0).long()  # empty ball -> 0


def ball_query(radius, nsample, xyz, new_xyz):
    """Indices [B, M, nsample] int64 of up to `nsample` points of xyz
    [B, N, 3] within `radius` of each centre of new_xyz [B, M, 3] (JAX
    sampling.py:80-110)."""
    with torch.profiler.record_function('ball_query'):
        return _hooked('ball', xyz.device, lambda: _ball_query(
            radius, nsample, xyz.float(), new_xyz.float()))


def group_points(points, idx):
    """out[b, m, s, c] = points[b, idx[b, m, s], c]."""
    B, M, S = idx.shape
    return _rows(points, idx.reshape(B, M * S)).reshape(
        B, M, S, points.shape[-1])


def three_nn(unknown, known):
    """(dist, idx): the squared distances [B, n, 3] and indices [B, n, 3]
    of the 3 nearest known points of each unknown point."""
    neg, idx = torch.topk(-_sqdist(unknown, known), 3, dim=-1)
    return -neg, idx


def three_interpolate(points, idx, weight):
    """[B, n, C]: the weighted sum of the 3 neighbours' features."""
    return (group_points(points, idx) * weight[..., None]).sum(2)
