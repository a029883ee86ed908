"""Linear sum assignment and equivalent-part matching, on the card.

Port of multi_part_assembly_tpu/ops/matching.py.  Semantic assembly
reorders the ground-truth poses of geometrically equivalent parts so that
they match the predictions at the least chamfer cost: one P x P linear
assignment problem (LAP) a shape, its cross-group entries masked to a large
constant, so that it splits into the per-group problems.

  - `solve_lap(cost)`: `[..., n, n]` f32 -> `[..., n]` int32, the column of
    each row.  A CUDA tensor launches kernel L1 (`mpa_lap`,
    csrc/matching.cu: one warp a problem, lane j owning column j, so
    n <= 32) or raises; a CPU tensor takes `solve_lap_plain`.
  - `solve_lap_plain(cost)`: the JAX shortest-augmenting-path solve
    (matching.py:25-87) over every problem at once, with fixed loop counts
    (a problem that is done is masked), so it never syncs with the host.
    It does the arithmetic in JAX's order and breaks ties towards the first
    minimum, as `jnp.argmin` does: on the same cost it gives JAX's
    assignment bit for bit, and so does the kernel.
  - `lap_cost_cuda(pts1, pts2, match_ids)`: kernel L2 (`mpa_lap_cost`,
    csrc/matching.cu), the block-masked cost `lap_cost(_pair_chamfer_cost(
    pts1, pts2), match_ids)` in one launch that visits only the in-group
    part pairs, with no [B, P, P, n, n] intermediate; n <= 256.
  - `match_parts`: the matching itself (JAX :149-217), under no_grad.  Its
    cost takes L2 for a CUDA tensor and the plain functions for a CPU
    tensor; any other device raises.

The JAX solve is XLA while-loops, not a Pallas kernel.  Eager PyTorch runs
the plain version as thousands of small launches a call (about 6,000 at
n = 20, whatever the number of problems), which is why the card has a
kernel for it.  Each launch of L1 counts `launch.lap`, each of L2
`launch.lap_cost`.
"""

import numpy as np
import torch

from ..utils import tracing
from ..utils.transforms import transform_pc
from .cuda_build import launch, require

__all__ = ['solve_lap', 'solve_lap_plain', 'solve_lap_cuda',
           'hungarian_scipy', 'match_parts', 'lap_cost', 'lap_cost_cuda',
           'MAX_LAP_N', 'MAX_LAP_COST_N']

_BIG = 1e9
# one warp a problem, one lane a column
MAX_LAP_N = 32
# L2: a thread a point in each of a block's two halves of at most 256
MAX_LAP_COST_N = 256


def solve_lap_plain(cost):
    """Exact LAP of every `[n, n]` problem of `cost` `[..., n, n]` f32 ->
    col4row `[..., n]` int32 (JAX `_solve_lap_single`, vectorised).

    Row r's Dijkstra search visits at most r + 1 columns (r are assigned),
    and its augmenting path has at most r + 1 steps: the loops run that
    many times, a problem that has finished masked out."""
    shape = cost.shape
    n = shape[-1]
    c = cost.reshape(-1, n, n).float()
    M, dev = c.shape[0], c.device
    rows = torch.arange(M, device=dev)
    cols = torch.arange(n, device=dev)
    inf = torch.tensor(float('inf'), device=dev)
    u = torch.zeros((M, n), device=dev)
    v = torch.zeros((M, n), device=dev)
    col4row = torch.full((M, n), -1, dtype=torch.long, device=dev)
    row4col = torch.full((M, n), -1, dtype=torch.long, device=dev)
    for cur in range(n):
        # --- Dijkstra from row `cur` until an unassigned column ---
        i = torch.full((M, ), cur, dtype=torch.long, device=dev)
        min_val = torch.zeros((M, ), device=dev)
        shortest = torch.full((M, n), float('inf'), device=dev)
        pathback = torch.full((M, n), -1, dtype=torch.long, device=dev)
        SR = torch.zeros((M, n), dtype=torch.bool, device=dev)
        SC = torch.zeros((M, n), dtype=torch.bool, device=dev)
        sink = torch.full((M, ), -1, dtype=torch.long, device=dev)
        for _ in range(cur + 1):
            active = sink < 0
            ic = i.clamp(min=0)
            SR[rows, ic] |= active
            r = ((min_val[:, None] + c[rows, ic]) - u[rows, ic][:, None]) - v
            upd = (r < shortest) & ~SC & active[:, None]
            shortest = torch.where(upd, r, shortest)
            pathback = torch.where(upd, ic[:, None], pathback)
            masked = torch.where(SC, inf, shortest)
            j = masked.argmin(dim=1)  # the first minimum, as jnp.argmin
            lowest = masked[rows, j]
            SC[rows, j] |= active
            nxt = row4col[rows, j]
            sink = torch.where(active & (nxt < 0), j, sink)
            min_val = torch.where(active, lowest, min_val)
            i = torch.where(active, nxt, i)
        # --- dual updates (JAX :62-66) ---
        u[:, cur] = u[:, cur] + min_val
        sr_other = SR & (cols != cur)
        sh = shortest.gather(1, col4row.clamp(min=0))
        u = torch.where(sr_other, (u + min_val[:, None]) - sh, u)
        v = torch.where(SC, v - (min_val[:, None] - shortest), v)
        # --- augment along the alternating path ---
        j = sink
        done = torch.zeros((M, ), dtype=torch.bool, device=dev)
        for _ in range(cur + 1):
            act = ~done
            ia = pathback[rows, j]
            row4col[rows, j] = torch.where(act, ia, row4col[rows, j])
            nxt = col4row[rows, ia]
            col4row[rows, ia] = torch.where(act, j, col4row[rows, ia])
            done = done | (ia == cur)
            j = torch.where(act, nxt, j)
    return col4row.to(torch.int32).reshape(shape[:-1])


def solve_lap_cuda(cost):
    """Kernel L1 on `[M, n, n]` f32 CUDA cost, contiguous, n <= 32 ->
    `[M, n]` int32 col4row."""
    M, n, _ = cost.shape
    require(cost, 'cost', torch.float32, (M, n, n), 'cuda')
    if n > MAX_LAP_N:
        raise ValueError(f'solve_lap on CUDA takes n <= {MAX_LAP_N} (one '
                         f'warp a problem), got n = {n}')
    out = torch.empty((M, n), dtype=torch.int32, device=cost.device)
    if M == 0 or n == 0:
        return out
    launch('mpa_lap', 'lap', cost.device, cost.data_ptr(), out.data_ptr(),
           M, n)
    return out


def solve_lap(cost):
    """Batched exact LAP (JAX `solve_lap`, matching.py:90-95): cost
    `[..., n, n]` -> col4row `[..., n]` int32.  Kernel L1 on a CUDA
    tensor; the plain version on a CPU tensor; any other device raises."""
    if cost.device.type == 'cpu':
        return solve_lap_plain(cost)
    if cost.device.type != 'cuda':
        raise ValueError(f'no LAP kernel for device {cost.device}')
    n = cost.shape[-1]
    flat = cost.reshape(-1, n, n).float().contiguous()
    return solve_lap_cuda(flat).reshape(cost.shape[:-1])


def hungarian_scipy(cost):
    """Host scipy solver, the yardstick of optimality (JAX :98-108)."""
    from scipy.optimize import linear_sum_assignment
    cost = np.asarray(cost)
    flat = cost.reshape((-1, ) + cost.shape[-2:])
    out = np.zeros(flat.shape[:2], np.int32)
    for i, c in enumerate(flat):
        _, cind = linear_sum_assignment(c)
        out[i] = cind
    return out.reshape(cost.shape[:-1])


def _pair_chamfer_cost(pts1, pts2):
    """Mean bidirectional chamfer between every part of pts1 and every part
    of pts2: [B, P, n, 3] each -> [B, P, P] (JAX :111-146).

    In f32: x2 + y2 - 2 xy with the cross term a plain matmul (TF32 off,
    as the trainer sets it), clamped at 0.  JAX packs bf16 splits for the
    TPU's matrix unit to reach about 2^-24; f32 is that here.  The CPU
    path and the tests' yardstick: a CUDA tensor takes kernel L2
    (`lap_cost_cuda`), which never builds the [B, P, P, n, n]
    intermediate."""
    x2 = (pts1 * pts1).sum(-1)  # [B, P, n]
    y2 = (pts2 * pts2).sum(-1)
    xy = torch.matmul(pts1[:, :, None], pts2[:, None].transpose(-1, -2))
    d = torch.clamp(x2[:, :, None, :, None] + y2[:, None, :, None, :]
                    - 2 * xy, min=0.0)  # [B, P, P, n, n]
    d1 = d.amin(dim=4).mean(dim=3)  # [B, P, P]
    d2 = d.amin(dim=3).mean(dim=3)
    return d1 + d2


def lap_cost(cost, match_ids):
    """The block-masked LAP cost (JAX :201-207): within a group (equal
    nonzero match_ids) the chamfer cost, _BIG elsewhere; an ungrouped row
    0 on its diagonal, so it keeps its own part."""
    P = cost.shape[-1]
    mid = match_ids.to(torch.int32)
    grouped = mid > 0
    in_block = (mid[:, :, None] == mid[:, None, :]) & grouped[:, :, None]
    diag = torch.eye(P, dtype=torch.bool, device=cost.device)[None]
    out = torch.where(in_block, cost, torch.full_like(cost, _BIG))
    return torch.where(diag & ~grouped[:, :, None], torch.zeros_like(out),
                       out)


def lap_cost_cuda(pts1, pts2, match_ids):
    """Kernel L2: `lap_cost(_pair_chamfer_cost(pts1, pts2), match_ids)` for
    pts1, pts2 `[B, P, n, 3]` f32 and match_ids `[B, P]` int32 on one CUDA
    device, contiguous, 1 <= n <= 256 -> `[B, P, P]` f32.  Its distances
    are direct differences, so its in-group entries differ from the plain
    f32 path's expanded form by that form's rounding; the rest are the same
    constants."""
    B, P, n, _ = pts1.shape
    require(pts1, 'pts1', torch.float32, (B, P, n, 3), 'cuda')
    require(pts2, 'pts2', torch.float32, (B, P, n, 3), pts1.device)
    require(match_ids, 'match_ids', torch.int32, (B, P), pts1.device)
    if not 1 <= n <= MAX_LAP_COST_N:
        raise ValueError(f'lap_cost on CUDA takes 1 <= n <= '
                         f'{MAX_LAP_COST_N} points a part, got n = {n}')
    out = torch.empty((B, P, P), dtype=torch.float32, device=pts1.device)
    if B * P == 0:
        return out
    launch('mpa_lap_cost', 'lap_cost', pts1.device, pts1.data_ptr(),
           pts2.data_ptr(), match_ids.data_ptr(), out.data_ptr(), B, P, n)
    return out


def _masked_cost(pts1, pts2, match_ids):
    """The LAP's block-masked cost: L2 on a CUDA tensor, the plain
    functions on a CPU tensor; any other device raises."""
    if pts1.device.type == 'cpu':
        return lap_cost(_pair_chamfer_cost(pts1, pts2), match_ids)
    if pts1.device.type != 'cuda':
        raise ValueError(f'no LAP cost kernel for device {pts1.device}')
    return lap_cost_cuda(pts1.contiguous(), pts2.contiguous(),
                         match_ids.to(torch.int32).contiguous())


@torch.no_grad()
def match_parts(part_pcs, pred_trans, pred_rot, gt_trans, gt_rot, match_ids,
                rot_type, generator=None, n_sample=100, sample_idx=None):
    """Permute the GT poses within groups of equivalent parts to match the
    predictions at least cost (JAX :149-217).

    Args:
        part_pcs: [B, P, N, 3]; pred_trans, gt_trans: [B, P, 3]
        pred_rot, gt_rot: [B, P, 4] quaternions or [B, P, 3, 3] matrices
        match_ids: [B, P] group labels (0: a part of its own, or padding)
        generator: draws the subsample of n_sample points (every part the
            same), `torch.randperm(N)[:n_sample]` on the clouds' device
        sample_idx: the subsample's indices instead of a draw

    Returns:
        (new_gt_trans, new_gt_rot), rows permuted within groups.
    """
    B, P, N, _ = part_pcs.shape
    if sample_idx is None:
        sample_idx = torch.randperm(N, generator=generator,
                                    device=part_pcs.device)[:n_sample]
    pts = part_pcs[:, :, sample_idx.to(part_pcs.device)]  # [B, P, n, 3]
    # the LAP's cost, a device region of its own (utils/tracing.py)
    with tracing.region('lap_cost', part_pcs.device):
        pts_pred = transform_pc(pred_trans, pred_rot, pts,
                                rot_type=rot_type)
        pts_gt = transform_pc(gt_trans, gt_rot, pts, rot_type=rot_type)
        cost = _masked_cost(pts_pred, pts_gt, match_ids)
    perm = solve_lap(cost).long()  # [B, P]
    new_trans = gt_trans.gather(1, perm[..., None].expand(B, P, 3))
    idx = perm.reshape(B, P, *([1] * (gt_rot.dim() - 2)))
    new_rot = gt_rot.gather(1, idx.expand(gt_rot.shape))
    return new_trans, new_rot
