"""Chamfer distance, forward and backward, on CUDA kernels.

Port of the chamfer of the JAX package (multi_part_assembly_tpu/ops/
chamfer.py).  Public contracts keep the JAX layout: part clouds are
[B, P, N, 3], valid parts are a prefix of the part axis given by a [B, P]
1/0 mask, padded parts give distance 0.

  - `chamfer_parts` (JAX `chamfer_parts`, chamfer.py:928-945): whole-shape
    chamfer over all valid parts -> dist1, dist2 [B, P*N].
  - `chamfer_diag` (JAX `chamfer_diag`, chamfer.py:1091-1103): part i of
    one cloud against part i of the other only -> dist1, dist2 [B, P, N].
  - `chamfer_pairs` (JAX :1106-1124): [M, N, 3] pairs as one-part shapes.
  - `chamfer_distance`, `nn_distance` (JAX :1127-1168): the reference
    repo's chamfer of [B, N1, 3] against [B, N2, 3].

Two routes serve the part-structured functions, picked by
`set_fused_mode` or `MPA_CHAMFER_FUSED` (JAX :948-983):
  - 'auto' and 'force' (the default): one call of `mpa_chamfer_pair`
    (csrc/chamfer.cu, B1/B3) gives both directions from one main launch,
    and records the first-hit witness of every point as a flat index into
    the other cloud's [P*N] points (-1 at padded parts); the backward is
    one launch of `mpa_chamfer_grad` (B2/B4) for both directions, which
    computes dy only when y needs a gradient and takes an unused
    distance's cotangent as absent.  The whole-shape forward visits every
    pair of valid parts; `nn_pair_cuda(..., prune=True)` visits only those
    that the JAX
    package's exact triangle-inequality rule keeps (JAX :740-790), with
    bit-identical results.
  - 'off', the JAX unfused route: one launch of `mpa_nn_parts` (B8) per
    direction, witnesses in the JAX numbering part * Npad + local (0 at
    padded parts), and a plain PyTorch backward (gather + index_add_, XLA's
    scatter in JAX).
`chamfer_distance` and `nn_distance` launch `mpa_nn_dir` (B7) once per
direction; their backward is plain PyTorch, as XLA's is in JAX.

Beside the kernels sit their plain PyTorch versions (`nn_pair_plain` and
`prune_keep_plain`, `chamfer_grad_plain`, `nn_parts_plain`,
`nn_dir_plain`), computing the same distance expression in the same order.
A CPU tensor takes the plain version of its route, since no kernel exists
for the CPU; a CUDA tensor launches the kernel or raises.  Each launch
counts `launch.<key>`, one key per (kernel, mode): `nn_parts`, `nn_diag`
(B1/B3), `bwd_parts`, `bwd_diag` (B2/B4), `nn_off` (B8), `nn_dir` (B7).
"""

import os

import torch
from torch.autograd.function import once_differentiable

from .cuda_build import launch, require

__all__ = ['chamfer_parts', 'chamfer_diag', 'chamfer_pairs',
           'chamfer_parts_ref', 'chamfer_diag_ref', 'chamfer_witnesses',
           'chamfer_distance', 'nn_distance', 'chamfer_distance_ref',
           'set_fused_mode', 'fused_mode', 'nn_pair_cuda', 'work_keep',
           'nn_pair_plain', 'nn_plain', 'pack_keys', 'unpack_keys',
           'prune_keep_plain', 'chamfer_grad_cuda',
           'chamfer_grad_plain', 'nn_parts_cuda', 'nn_parts_plain',
           'nn_dir_cuda', 'nn_dir_plain']

# query rows per distance block of the plain whole-shape version: bounds
# its [rows, P*N] f32 temporaries (one dense [P*N]^2 tile is 1.6 GB at
# P=20, N=1000); on the CPU fewer, so that a block's temporaries stay in
# cache (a 2048-row block is 164 MB a temporary at P*N = 20000)
_PLAIN_ROWS = 2048
_PLAIN_ROWS_CPU = 128
# pair distances per block of `nn_dir_plain`: bounds its [nb, rows, N2] f32
# temporaries (one repulsion scan row, 640 clouds of 1000 x 1000, would be
# 2.56 GB a temporary)
_PLAIN_PAIRS = 2**25
# the JAX kernels pad each part's points to a multiple of the TPU's 128
# lanes; the unfused route keeps that numbering of its witnesses
_LANES = 128
_MODES = ('auto', 'force', 'off')
_FUSED_MODE = 'auto'


def _part_counts(valids):
    """[B, P] 1/0 prefix mask -> [B] int32 valid-part counts."""
    return valids.to(torch.int32).sum(1, dtype=torch.int32)


def _round_up(x, m):
    return (x + m - 1) // m * m


def set_fused_mode(mode):
    """Route of `chamfer_parts`/`chamfer_diag` (JAX chamfer.py:961-965):
    'auto' and 'force' take the fused kernels B1-B4, 'off' the unfused
    route (B8).  JAX's 'force' means Pallas in interpret mode off the TPU,
    which has no counterpart here.  On a CPU tensor every mode takes the
    plain version of its route."""
    global _FUSED_MODE
    if mode not in _MODES:
        raise ValueError(f'fused mode must be one of {_MODES}, got {mode!r}')
    _FUSED_MODE = mode


def fused_mode():
    """The current route: 'auto', 'force' or 'off'."""
    return _FUSED_MODE


set_fused_mode(os.environ.get('MPA_CHAMFER_FUSED', 'auto'))

# relative slack of the pruning bounds (JAX chamfer.py:776-778)
_PRUNE_SLACK = 1e-4


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def nn_pair_cuda(x, y, n_parts, diagonal, prune=False, work=None):
    """Kernel B1/B3: both directions of the part-structured nearest
    neighbour in one main launch: every valid point of x among the valid
    parts of y (or its own part when `diagonal`), and every valid point of
    y among those of x.

    Replaces `_fused_parts_fwd_kernel` (chamfer.py:483) and
    `_fused_diag_fwd_kernel` (:556), launched by `_fused_parts_fwd_pallas`
    (:793).  The whole-shape mode visits every pair of valid parts, or with
    `prune` only the pairs that `prune_keep_plain`'s rule keeps; the
    results are the same bit for bit.

    Args:
        x, y: [B, P, N, 3] f32 CUDA, contiguous
        n_parts: [B] int32 valid-prefix counts
        work: optional [1 + B*P*P] int32 CUDA tensor that receives the list
            of visited part pairs (`work_keep` decodes it)

    Returns:
        dist1, dist2 [B, P, N] f32 (0 at padded parts), witness1, witness2
        [B, P, N] int32 (flat index into the other cloud's [P*N] points,
        -1 at padded parts)
    """
    B, P, N, _ = x.shape
    require(x, 'x', torch.float32, (B, P, N, 3), 'cuda')
    require(y, 'y', torch.float32, (B, P, N, 3), x.device)
    require(n_parts, 'n_parts', torch.int32, (B, ), x.device)
    if B * P * P >= 2**31:
        raise ValueError(f'B * P * P = {B * P * P}: the work list holds '
                         'int32 part-pair ids')
    mode = 2 if diagonal else int(bool(prune))
    dev = x.device
    keys = torch.empty(2 * B * P * N, dtype=torch.int64, device=dev)
    if work is None:
        work = torch.empty(1 + B * P * P, dtype=torch.int32, device=dev)
    require(work, 'work', torch.int32, (1 + B * P * P, ), x.device)
    d1, d2 = (torch.empty((B, P, N), dtype=torch.float32, device=dev)
              for _ in range(2))
    w1, w2 = (torch.empty((B, P, N), dtype=torch.int32, device=dev)
              for _ in range(2))
    launch('mpa_chamfer_pair', 'nn_diag' if diagonal else 'nn_parts', dev,
           x.data_ptr(), y.data_ptr(), n_parts.data_ptr(), keys.data_ptr(),
           work.data_ptr(), d1.data_ptr(), d2.data_ptr(), w1.data_ptr(),
           w2.data_ptr(), B, P, N, mode)
    return d1, d2, w1, w2


def work_keep(work, B, P):
    """The part-pair list that `nn_pair_cuda` wrote into `work`, as a
    [B, P, P] bool mask (x-part, y-part); with `prune`, the kernel side of
    `prune_keep_plain`.  Reads the list's count, so it synchronises."""
    keep = torch.zeros(B * P * P, dtype=torch.bool, device=work.device)
    keep[work[1:1 + int(work[0])].long()] = True
    return keep.view(B, P, P)


def chamfer_grad_cuda(x, y, n_parts, w1, w2, g1, g2, diagonal, need_dy):
    """Kernel B2/B4: the gradient of both directions of the part-structured
    chamfer from the forward's witnesses, in one launch.

    Replaces `_fused_parts_bwd_kernel` (chamfer.py:632) and
    `_fused_diag_bwd_kernel` (:687), launched by `_fused_parts_bwd_pallas`
    (:866).  Each block owns a chunk of one part's gradient rows and writes
    them whole: the outputs come from `torch.empty`, with no zero-fill.

    Args:
        x, y: [B, P, N, 3] f32 CUDA, contiguous
        n_parts: [B] int32 valid-prefix counts
        w1, w2: [B, P, N] int32 witnesses of `nn_pair_cuda`
        g1, g2: [B, P, N] f32 cotangents of dist1, dist2, or None (no
            contribution; never materialised as zeros)
        need_dy: whether to compute dy

    Returns:
        dx [B, P, N, 3] f32, and dy likewise or None when not `need_dy`;
        exact zeros at padded parts
    """
    B, P, N, _ = x.shape
    require(x, 'x', torch.float32, (B, P, N, 3), 'cuda')
    require(y, 'y', torch.float32, (B, P, N, 3), x.device)
    require(n_parts, 'n_parts', torch.int32, (B, ), x.device)
    require(w1, 'w1', torch.int32, (B, P, N), x.device)
    require(w2, 'w2', torch.int32, (B, P, N), x.device)
    for g, name in ((g1, 'g1'), (g2, 'g2')):
        if g is not None:
            require(g, name, torch.float32, (B, P, N), x.device)
    dx = torch.empty_like(x)
    dy = torch.empty_like(y) if need_dy else None
    launch('mpa_chamfer_grad', 'bwd_diag' if diagonal else 'bwd_parts',
           x.device, x.data_ptr(), y.data_ptr(), n_parts.data_ptr(),
           w1.data_ptr(), w2.data_ptr(),
           None if g1 is None else g1.data_ptr(),
           None if g2 is None else g2.data_ptr(), dx.data_ptr(),
           None if dy is None else dy.data_ptr(), B, P, N,
           2 if diagonal else 0)
    return dx, dy


def nn_parts_cuda(x, y, n_parts):
    """Kernel B8: nearest neighbour of every valid point of x among the
    valid parts of y, one direction of the unfused route: B1's work list,
    pair kernel (with the other direction compiled out) and unpack, over
    scratch allocated here.

    Replaces `_nn_parts_pallas` (chamfer.py:330-374, body
    `_nn_parts_kernel` :284).

    Args:
        x, y: [B, P, N, 3] f32 CUDA, contiguous
        n_parts: [B] int32 valid-prefix counts

    Returns:
        dist [B, P, N] f32 (clamped at 0; 0 at padded parts), idx [B, P, N]
        int32 in the JAX numbering part * Npad + local, Npad =
        round_up(N, 128) (0 at padded parts)
    """
    B, P, N, _ = x.shape
    require(x, 'x', torch.float32, (B, P, N, 3), 'cuda')
    require(y, 'y', torch.float32, (B, P, N, 3), x.device)
    require(n_parts, 'n_parts', torch.int32, (B, ), x.device)
    if B * P * P >= 2**31:
        raise ValueError(f'B * P * P = {B * P * P}: the work list holds '
                         'int32 part-pair ids')
    dev = x.device
    keys = torch.empty(B * P * N, dtype=torch.int64, device=dev)
    work = torch.empty(1 + B * P * P, dtype=torch.int32, device=dev)
    dist = torch.empty((B, P, N), dtype=torch.float32, device=dev)
    idx = torch.empty((B, P, N), dtype=torch.int32, device=dev)
    launch('mpa_nn_parts', 'nn_off', dev, x.data_ptr(), y.data_ptr(),
           n_parts.data_ptr(), keys.data_ptr(), work.data_ptr(),
           dist.data_ptr(), idx.data_ptr(), B, P, N, _round_up(N, _LANES))
    return dist, idx


def nn_dir_cuda(x, y):
    """Kernel B7: nearest neighbour of each point of x among the points of
    y in the same cloud.

    Replaces `_nn_direction_pallas` (chamfer.py:149-187, body `_nn_kernel`
    :110).  It launches for any size: JAX's N1 * N2 >= 128 * 128 threshold
    (:195) is a TPU cost choice.

    Args:
        x: [B, N1, 3], y: [B, N2, 3] f32 CUDA, contiguous; N2 >= 1

    Returns:
        dist [B, N1] f32 (clamped at 0), idx [B, N1] int32 into y's points
    """
    B, N1, _ = x.shape
    N2 = y.shape[1]
    require(x, 'x', torch.float32, (B, N1, 3), 'cuda')
    require(y, 'y', torch.float32, (B, N2, 3), x.device)
    if N2 == 0:
        raise ValueError('y: no target points')
    dist = torch.empty((B, N1), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, N1), dtype=torch.int32, device=x.device)
    launch('mpa_nn_dir', 'nn_dir', x.device, x.data_ptr(), y.data_ptr(),
           dist.data_ptr(), idx.data_ptr(), B, N1, N2)
    return dist, idx


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _sqdist(a, b):
    """[..., M, 3] x [..., K, 3] -> [..., M, K] squared distances, as the
    kernel computes them: (dx*dx + dy*dy) + dz*dz, each op rounded.  On
    the CPU outside autograd the same ops run in place, in two temporaries
    instead of eight."""
    if a.device.type != 'cpu' or (torch.is_grad_enabled() and (
            a.requires_grad or b.requires_grad)):
        dx = a[..., :, None, 0] - b[..., None, :, 0]
        dy = a[..., :, None, 1] - b[..., None, :, 1]
        dz = a[..., :, None, 2] - b[..., None, :, 2]
        return (dx * dx + dy * dy) + dz * dz
    d = a[..., :, None, 0] - b[..., None, :, 0]
    d.mul_(d)
    t = a[..., :, None, 1] - b[..., None, :, 1]
    d.add_(t.mul_(t))
    torch.sub(a[..., :, None, 2], b[..., None, :, 2], out=t)
    return d.add_(t.mul_(t))


def nn_plain(query, target, n_parts, diagonal, keep=None):
    """Plain nearest neighbour, one direction: every valid query point
    among the valid target parts (its own part when `diagonal`).  Returns
    dist [B, P, N] f32 (0 at padded parts) and witness [B, P, N] int32
    (flat index into target's [P*N] points, -1 at padded parts).  Loops
    over the batch; torch.min returns the first minimum, the kernels'
    first-hit rule.  `keep` ([B, P, P] bool, query part x target part)
    restricts the whole-shape form to the kept part pairs."""
    B, P, N, _ = query.shape
    dist = query.new_zeros((B, P, N))
    witness = torch.full((B, P, N), -1, dtype=torch.int32,
                         device=query.device)
    on_cpu = query.device.type == 'cpu'
    rows = _PLAIN_ROWS_CPU if on_cpu else _PLAIN_ROWS
    for b, n_p in enumerate(n_parts.clamp(0, P).tolist()):
        if n_p == 0:
            continue
        if diagonal:
            # a part at a time on the CPU, all parts at once on the card
            step = 1 if on_cpu else n_p
            for p in range(0, n_p, step):
                m, a = _sqdist(query[b, p:p + step],
                               target[b, p:p + step]).min(dim=-1)
                offset = torch.arange(p, p + m.shape[0],
                                      device=query.device)[:, None] * N
                dist[b, p:p + step] = m
                witness[b, p:p + step] = (a + offset).to(torch.int32)
            continue
        q = query[b, :n_p].reshape(n_p * N, 3)
        t = target[b, :n_p].reshape(n_p * N, 3)
        d_out = dist[b, :n_p].view(-1)
        w_out = witness[b, :n_p].view(-1)
        part = torch.arange(n_p * N, device=query.device) // N
        for r in range(0, n_p * N, rows):
            d = _sqdist(q[r:r + rows], t)
            if keep is not None:
                kept = keep[b, :n_p, :n_p][part[r:r + rows]][:, part]
                d = d.masked_fill(~kept, float('inf'))
            m, a = d.min(dim=-1)
            d_out[r:r + rows] = m
            w_out[r:r + rows] = a.to(torch.int32)
    return dist, witness


def nn_pair_plain(x, y, n_parts, diagonal, keep=None):
    """Plain version of `nn_pair_cuda`, same contract: `nn_plain` in both
    directions, restricted to the part pairs of `keep` ([B, P, P] bool,
    x-part x y-part) when it is given."""
    d1, w1 = nn_plain(x, y, n_parts, diagonal, keep)
    d2, w2 = nn_plain(y, x, n_parts, diagonal,
                      None if keep is None else keep.transpose(1, 2))
    return d1, d2, w1, w2


def pack_keys(dist, witness):
    """B1/B3's packed minimum, as int64: (float bits of dist) << 32 |
    (index as uint32; the kernel stores the first index of an aligned
    group of 8 candidates and resolves it to the witness at the end).  For
    dist >= +0 the order of the keys is the lexicographic order of (dist,
    index), so their minimum holds the smallest index among equal minima,
    in whatever order they are merged."""
    bits = dist.float().contiguous().view(torch.int32).long()
    return (bits << 32) | (witness.long() & 0xFFFFFFFF)


def unpack_keys(keys):
    """Inverse of `pack_keys`: (dist f32, witness int32)."""
    dist = (keys >> 32).to(torch.int32).view(torch.float32)
    witness = (keys & 0xFFFFFFFF).to(torch.int32)
    return dist, witness


def prune_keep_plain(x, y, n_parts):
    """The exact part-pair keep rule of the whole-shape forward, the JAX
    package's `_forward_pairs` at one y-part a group (chamfer.py:740-790).

    With per-part centroids c and radii r (largest distance to the
    centroid), D_ij = |c1_i - c2_j| and rsum_ij = r1_i + r2_j, every
    distance between x-part i and y-part j is at least lb_ij = max(D_ij -
    rsum_ij - slack, 0), and every point of x-part i has a neighbour
    within ub1_i = min_j (D_ij + rsum_ij) (ub2_j likewise for y).  Pair
    (i, j) is kept when lb_ij <= ub1_i or lb_ij <= ub2_j: a dropped pair can
    neither win nor tie a minimum.  The slack, 1e-4 (D + rsum), covers the
    rounding of the reductions.

    Args:
        x, y: [B, P, N, 3] f32;  n_parts: [B] int

    Returns:
        [B, P, P] bool, False at every pair with a padded part
    """
    P = x.shape[1]
    c1, c2 = x.mean(2), y.mean(2)
    r1 = ((x - c1[:, :, None]) ** 2).sum(-1).amax(2).sqrt()
    r2 = ((y - c2[:, :, None]) ** 2).sum(-1).amax(2).sqrt()
    D = ((c1[:, :, None] - c2[:, None]) ** 2).sum(-1).sqrt()
    rsum = r1[:, :, None] + r2[:, None]
    valid = torch.arange(P, device=x.device)[None] < n_parts[:, None]
    pair_valid = valid[:, :, None] & valid[:, None, :]
    inf = torch.tensor(float('inf'), device=x.device)
    ub = torch.where(pair_valid, D + rsum, inf)
    lb = (D - rsum - _PRUNE_SLACK * (D + rsum)).clamp_min(0.0)
    lb = torch.where(pair_valid, lb, inf)
    ub1, ub2 = ub.amin(2), ub.amin(1)
    return pair_valid & ((lb <= ub1[:, :, None]) | (lb <= ub2[:, None, :]))


def _grad_terms(query, target, witness, grad):
    """One direction's terms 2 g (q - t_w) [B*P*N, 3] (0 at witness -1) and
    the flat rows [B*P*N] of their witnesses in the target."""
    B, P, N, _ = query.shape
    w = witness.reshape(B, P * N).long()
    idx = w.clamp(min=0)
    t_w = torch.gather(target.reshape(B, P * N, 3), 1,
                       idx[..., None].expand(B, P * N, 3))
    diff = (2.0 * grad.reshape(B, P * N, 1)) * \
        (query.reshape(B, P * N, 3) - t_w)
    diff = torch.where((w >= 0)[..., None], diff, torch.zeros_like(diff))
    flat = idx + torch.arange(B, device=idx.device)[:, None] * (P * N)
    return diff.reshape(-1, 3), flat.reshape(-1)


def chamfer_grad_plain(x, y, n_parts, w1, w2, g1, g2, diagonal, need_dy):
    """Plain version of `chamfer_grad_cuda`, same contract: gather +
    index_add_, own terms first, then the witnesses' negated terms.  The
    witnesses carry the part structure, so `n_parts` and `diagonal` change
    nothing here."""
    del n_parts, diagonal
    dx = torch.zeros_like(x)
    dy = torch.zeros_like(y) if need_dy else None
    t1 = None if g1 is None else _grad_terms(x, y, w1, g1)
    t2 = None if g2 is None else _grad_terms(y, x, w2, g2)
    if t1 is not None:
        dx.view(-1, 3).add_(t1[0])
    if t2 is not None and need_dy:
        dy.view(-1, 3).add_(t2[0])
    if t2 is not None:
        dx.view(-1, 3).index_add_(0, t2[1], -t2[0])
    if t1 is not None and need_dy:
        dy.view(-1, 3).index_add_(0, t1[1], -t1[0])
    return dx, dy


def nn_parts_plain(x, y, n_parts):
    """Plain version of `nn_parts_cuda`, same contract (JAX `_nn_parts_ref`,
    chamfer.py:377-392): the whole-shape `nn_plain` renumbered."""
    N = x.shape[2]
    dist, w = nn_plain(x, y, n_parts, diagonal=False)
    wl = w.long()
    idx = torch.where(w >= 0, (wl // N) * _round_up(N, _LANES) + wl % N, 0)
    return dist.clamp_min(0.0), idx.to(torch.int32)


def nn_dir_plain(x, y):
    """Plain version of `nn_dir_cuda`, same contract (JAX `_nn_direction`,
    chamfer.py:190-199), in blocks of clouds and query rows of at most
    `_PLAIN_PAIRS` pair distances."""
    B, N1, _ = x.shape
    N2 = y.shape[1]
    if N2 == 0:
        raise ValueError('y: no target points')
    dist = x.new_empty((B, N1))
    idx = torch.empty((B, N1), dtype=torch.int32, device=x.device)
    rows = max(1, min(N1, _PLAIN_PAIRS // N2))
    nb = max(1, _PLAIN_PAIRS // (rows * N2))
    for b in range(0, B, nb):
        for r in range(0, N1, rows):
            m, a = _sqdist(x[b:b + nb, r:r + rows], y[b:b + nb]).min(dim=-1)
            dist[b:b + nb, r:r + rows] = m.clamp_min(0.0)
            idx[b:b + nb, r:r + rows] = a.to(torch.int32)
    return dist, idx


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------


class _Chamfer(torch.autograd.Function):
    """Both directions of the chamfer; saves the witnesses for a backward
    without recompute (the JAX custom VJP, chamfer.py:991-1084)."""

    @staticmethod
    def forward(ctx, x, y, n_parts, diagonal, plain):
        nn = nn_pair_plain if plain else nn_pair_cuda
        d1, d2, w1, w2 = nn(x, y, n_parts, diagonal)
        ctx.save_for_backward(x, y, n_parts, w1, w2)
        ctx.diagonal, ctx.plain = diagonal, plain
        ctx.mark_non_differentiable(w1, w2)
        # an unused distance reaches the backward as None, not as zeros
        ctx.set_materialize_grads(False)
        return d1, d2, w1, w2

    @staticmethod
    @once_differentiable
    def backward(ctx, g1, g2, _gw1, _gw2):
        x, y, n_parts, w1, w2 = ctx.saved_tensors
        grad = chamfer_grad_plain if ctx.plain else chamfer_grad_cuda
        dx, dy = grad(x, y, n_parts, w1, w2,
                      None if g1 is None else g1.contiguous(),
                      None if g2 is None else g2.contiguous(),
                      ctx.diagonal, ctx.needs_input_grad[1])
        return dx, dy, None, None, None


def _plain_for(t, plain=False):
    """Whether tensor `t` takes the plain versions: always on the CPU, when
    asked on CUDA; any other device raises."""
    if t.device.type == 'cpu':
        return True
    if t.device.type != 'cuda':
        raise ValueError(f'no chamfer kernel for device {t.device}')
    return plain


def _parts_args(pts1, pts2, valids, plain=False):
    """(x, y, n_parts, plain) as both routes' autograd Functions take them."""
    x = pts1.float().contiguous()
    y = pts2.float().contiguous()
    return x, y, _part_counts(valids).contiguous(), _plain_for(x, plain)


def chamfer_witnesses(pts1, pts2, valids, *, diagonal, plain=False):
    """Fused route: (dist1, dist2, witness1, witness2), each [B, P, N];
    distances are differentiable.  `plain=True` forces the plain version on
    any device (the kernels' comparison); otherwise a CUDA tensor launches
    the kernels and a CPU tensor takes the plain version."""
    x, y, n_parts, plain = _parts_args(pts1, pts2, valids, plain)
    return _Chamfer.apply(x, y, n_parts, diagonal, plain)


def _parts_bwd_one(g, x, y, idx, npad):
    """Gradient of one direction d_i = |x_i - y_idx_i|^2 with idx in the JAX
    numbering (JAX `_parts_bwd_one`, chamfer.py:914-925): gather, then
    index_add_ into y viewed as [B, P*npad]."""
    B, P, N, _ = x.shape
    yf = torch.nn.functional.pad(y, (0, 0, 0, npad - N)).reshape(
        B, P * npad, 3)
    idxf = idx.reshape(B, P * N).long().clamp(0, P * npad - 1)
    w = torch.gather(yf, 1, idxf[..., None].expand(B, P * N, 3))
    diff = 2.0 * g.reshape(B, P * N, 1) * (x.reshape(B, P * N, 3) - w)
    flat = idxf + torch.arange(B, device=idxf.device)[:, None] * (P * npad)
    dyf = torch.zeros_like(yf).view(B * P * npad, 3).index_add_(
        0, flat.reshape(-1), -diff.reshape(-1, 3))
    return diff.view(B, P, N, 3), dyf.view(B, P, npad, 3)[:, :, :N]


class _ChamferUnfused(torch.autograd.Function):
    """Both directions of the unfused route (JAX chamfer.py:1031-1044 and
    :1063-1081): one B8 launch per direction; the diagonal form runs B*P
    one-part shapes with 0/1 flags.  The backward is plain PyTorch, as it
    is XLA in the JAX package."""

    @staticmethod
    def forward(ctx, x, y, n_parts, diagonal, plain):
        B, P, N, _ = x.shape
        nn = nn_parts_plain if plain else nn_parts_cuda
        if diagonal:
            counts = (torch.arange(P, device=x.device)[None] <
                      n_parts[:, None]).to(torch.int32).reshape(B * P)
            x1, x2 = x.view(B * P, 1, N, 3), y.view(B * P, 1, N, 3)
        else:
            counts, x1, x2 = n_parts, x, y
        d1, i1 = nn(x1, x2, counts)
        d2, i2 = nn(x2, x1, counts)
        ctx.save_for_backward(x, y, i1, i2, n_parts)
        ctx.diagonal = diagonal
        return d1.view(B, P, N), d2.view(B, P, N)

    @staticmethod
    @once_differentiable
    def backward(ctx, g1, g2):
        x, y, i1, i2, n_parts = ctx.saved_tensors
        B, P, N, _ = x.shape
        npad = _round_up(N, _LANES)
        # zero the cotangents at padded parts: their distances are 0 and
        # their index 0 points at a real target
        valid = (torch.arange(P, device=x.device)[None] <
                 n_parts[:, None])[..., None]
        g1 = torch.zeros_like(x[..., 0]) if g1 is None else \
            torch.where(valid, g1, 0.0)
        g2 = torch.zeros_like(x[..., 0]) if g2 is None else \
            torch.where(valid, g2, 0.0)
        if ctx.diagonal:
            sh = (B * P, 1, N)
            x1, x2 = x.view(B * P, 1, N, 3), y.view(B * P, 1, N, 3)
            dx_a, dy_a = _parts_bwd_one(g1.reshape(sh), x1, x2, i1, npad)
            dy_b, dx_b = _parts_bwd_one(g2.reshape(sh), x2, x1, i2, npad)
            return (dx_a + dx_b).reshape(x.shape), \
                (dy_a + dy_b).reshape(y.shape), None, None, None
        dx_a, dy_a = _parts_bwd_one(g1, x, y, i1, npad)
        dy_b, dx_b = _parts_bwd_one(g2, y, x, i2, npad)
        return dx_a + dx_b, dy_a + dy_b, None, None, None


def _parts_route(pts1, pts2, valids, diagonal):
    """dist1, dist2 [B, P, N] through the route `fused_mode()` picks."""
    x, y, n_parts, plain = _parts_args(pts1, pts2, valids)
    if _FUSED_MODE == 'off':
        return _ChamferUnfused.apply(x, y, n_parts, diagonal, plain)
    d1, d2, _, _ = _Chamfer.apply(x, y, n_parts, diagonal, plain)
    return d1, d2


def chamfer_parts(pts1, pts2, valids):
    """Whole-shape chamfer over the valid prefix parts
    (JAX ops/chamfer.py:928-945).

    Args:
        pts1, pts2: [B, P, N, 3] (already posed);  valids: [B, P] 1/0

    Returns:
        dist1, dist2: [B, P*N] squared distances (0 at padded parts)
    """
    B, P, N, _ = pts1.shape
    d1, d2 = _parts_route(pts1, pts2, valids, diagonal=False)
    return d1.reshape(B, P * N), d2.reshape(B, P * N)


def chamfer_diag(pts1, pts2, valids):
    """Per-part chamfer, part i against part i (JAX ops/chamfer.py:1091-1103).

    Returns:
        dist1, dist2: [B, P, N] (0 at padded parts)
    """
    return _parts_route(pts1, pts2, valids, diagonal=True)


def chamfer_pairs(pts1, pts2, pair_valids):
    """Per-pair chamfer, each pair a one-part shape for `chamfer_parts`, so
    invalid pairs give 0 (JAX ops/chamfer.py:1106-1124).

    Args:
        pts1, pts2: [M, N, 3];  pair_valids: [M] 1/0

    Returns:
        dist1, dist2: [M, N]
    """
    M = pts1.shape[0]
    return chamfer_parts(pts1[:, None], pts2[:, None],
                         pair_valids.reshape(M, 1))


def chamfer_parts_ref(pts1, pts2, valids):
    """Plain version of the fused `chamfer_parts` with witnesses:
    (dist1, witness1, dist2, witness2), each [B, P*N]."""
    B, P, N, _ = pts1.shape
    d1, d2, w1, w2 = chamfer_witnesses(pts1, pts2, valids, diagonal=False,
                                       plain=True)
    return tuple(v.reshape(B, P * N) for v in (d1, w1, d2, w2))


def chamfer_diag_ref(pts1, pts2, valids):
    """Plain version of the fused `chamfer_diag` with witnesses:
    (dist1, witness1, dist2, witness2), each [B, P, N]."""
    d1, d2, w1, w2 = chamfer_witnesses(pts1, pts2, valids, diagonal=True,
                                       plain=True)
    return d1, w1, d2, w2


# ---------------------------------------------------------------------------
# the reference repo's chamfer API on [B, N1, 3] x [B, N2, 3] (B7)
# ---------------------------------------------------------------------------


class _ChamferDir(torch.autograd.Function):
    """Both directions of one B7 launch each; saves the indices for the
    backward, a port of JAX `_chamfer_bwd` (chamfer.py:220-238) in plain
    PyTorch: gather the witnesses, index_add_ their negated terms."""

    @staticmethod
    def forward(ctx, x, y, plain):
        nn = nn_dir_plain if plain else nn_dir_cuda
        d1, i1 = nn(x, y)
        d2, i2 = nn(y, x)
        ctx.save_for_backward(x, y, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, i1, d2, i2

    @staticmethod
    @once_differentiable
    def backward(ctx, g1, _gi1, g2, _gi2):
        x, y, i1, i2 = ctx.saved_tensors
        g1 = torch.zeros_like(x[..., 0]) if g1 is None else g1
        g2 = torch.zeros_like(y[..., 0]) if g2 is None else g2
        i1, i2 = i1.long(), i2.long()
        y_w = torch.gather(y, 1, i1[..., None].expand_as(x))
        diff1 = 2.0 * g1[..., None] * (x - y_w)
        x_w = torch.gather(x, 1, i2[..., None].expand_as(y))
        diff2 = 2.0 * g2[..., None] * (y - x_w)
        B, N1, _ = x.shape
        N2 = y.shape[1]
        arange = torch.arange(B, device=x.device)[:, None]
        dy = diff2 + torch.zeros_like(y).view(B * N2, 3).index_add_(
            0, (i1 + arange * N2).reshape(-1), -diff1.reshape(-1, 3)
        ).view_as(y)
        dx = diff1 + torch.zeros_like(x).view(B * N1, 3).index_add_(
            0, (i2 + arange * N1).reshape(-1), -diff2.reshape(-1, 3)
        ).view_as(x)
        return dx, dy, None


def _nn_both(xyz1, xyz2, transpose, plain):
    if transpose:
        xyz1, xyz2 = xyz1.transpose(1, 2), xyz2.transpose(1, 2)
    x = xyz1.float().contiguous()
    y = xyz2.float().contiguous()
    return _ChamferDir.apply(x, y, _plain_for(x, plain))


def chamfer_distance(xyz1, xyz2, transpose=False, sqrt=False, eps=1e-12, *,
                     plain=False):
    """Chamfer distance between two batched point clouds
    (JAX ops/chamfer.py:1127-1153, the reference repo's API).

    Args:
        xyz1: [B, N1, 3] (or [B, 3, N1] with transpose=True; [N1, 3] gets a
            batch axis);  xyz2: [B, N2, 3] likewise
        sqrt: return sqrt(max(d, eps)) of the squared distances
        plain: force the plain version on a CUDA tensor (the kernel's
            comparison)

    Returns:
        (dist1 [B, N1], dist2 [B, N2])
    """
    if xyz1.dim() == 2:
        xyz1, xyz2 = xyz1[None], xyz2[None]
    dist1, _, dist2, _ = _nn_both(xyz1, xyz2, transpose, plain)
    if sqrt:
        dist1 = torch.sqrt(dist1.clamp_min(eps))
        dist2 = torch.sqrt(dist2.clamp_min(eps))
    return dist1, dist2


def nn_distance(xyz1, xyz2, transpose=False, sqrt=False, *, plain=False):
    """Chamfer plus nearest-neighbour indices (JAX ops/chamfer.py:1156-1168):
    (dist1 [B, N1], idx1 [B, N1], dist2 [B, N2], idx2 [B, N2])."""
    dist1, idx1, dist2, idx2 = _nn_both(xyz1, xyz2, transpose, plain)
    if sqrt:
        dist1 = torch.sqrt(dist1.clamp_min(1e-12))
        dist2 = torch.sqrt(dist2.clamp_min(1e-12))
    return dist1, idx1, dist2, idx2


def chamfer_distance_ref(xyz1, xyz2):
    """Naive full-matrix chamfer (JAX ops/chamfer.py:95-102), the port's
    distance expression: (dist1, idx1, dist2, idx2)."""
    d = _sqdist(xyz1.float(), xyz2.float())
    dist1, idx1 = d.min(dim=2)
    dist2, idx2 = d.min(dim=1)
    return dist1, idx1.to(torch.int32), dist2, idx2.to(torch.int32)
