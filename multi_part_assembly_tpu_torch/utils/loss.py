"""Assembly losses with masked semantics, on the port's chamfer.

Port of multi_part_assembly_tpu/utils/loss.py:22-154.  Every loss returns
a [B] tensor: the mean over each shape's valid parts (over valid part
pairs for `repulsion_cd_loss`).
"""

import torch

from ..ops.chamfer import chamfer_diag, chamfer_distance, chamfer_parts
from .transforms import rot_pc, transform_pc

__all__ = ['_valid_mean', 'trans_l2_loss', 'rot_l2_loss', 'rot_cosine_loss',
           'rot_points_l2_loss', 'rot_points_cd_loss', 'shape_cd_loss',
           'repulsion_cd_matrix', 'repulsion_cd_loss']


def _valid_mean(loss_per_part, valids):
    """[B, P] per-part loss -> [B] mean over valid parts
    (JAX loss.py:22-31; no gradient through the mask)."""
    valids = valids.to(loss_per_part.dtype).detach()
    return (loss_per_part * valids).sum(1) / valids.sum(1)


def trans_l2_loss(trans1, trans2, valids):
    """Squared-L2 translation loss (JAX loss.py:34-37)."""
    return _valid_mean(((trans1 - trans2)**2).sum(-1), valids)


def rot_l2_loss(rot1, rot2, valids):
    """min(|q1 - q2|^2, |q1 + q2|^2), since q and -q are one rotation
    (JAX loss.py:40-46)."""
    assert rot1.rot_type == rot2.rot_type == 'quat'
    q1, q2 = rot1.rot, rot2.rot
    l2_1 = ((q1 - q2)**2).sum(-1)
    l2_2 = ((q1 + q2)**2).sum(-1)
    return _valid_mean(torch.minimum(l2_1, l2_2), valids)


def rot_cosine_loss(rot1, rot2, valids):
    """Cosine rotation loss (JAX loss.py:49-66): quat 1 - |<q1, q2>|; rmat
    the mean of (I - R1^T R2)^2, R1^T R2 as a broadcast multiply and a sum
    (exact f32, as JAX's HIGHEST-precision einsum)."""
    assert rot1.rot_type == rot2.rot_type
    if rot1.rot_type == 'quat':
        loss_per_part = 1.0 - torch.abs((rot1.rot * rot2.rot).sum(-1))
    elif rot1.rot_type == 'rmat':
        r1, r2 = rot1.rot, rot2.rot  # [B, P, 3, 3]
        rtr = (r1[..., :, :, None] * r2[..., :, None, :]).sum(-3)
        iden = torch.eye(3, dtype=rtr.dtype, device=rtr.device)
        loss_per_part = ((iden - rtr)**2).mean((-1, -2))
    else:
        raise NotImplementedError(
            f'cosine loss not supported for {rot1.rot_type}')
    return _valid_mean(loss_per_part, valids)


def rot_points_l2_loss(pts, rot1, rot2, valids):
    """Per-point L2 between differently rotated parts (JAX loss.py:69-77)."""
    pts1 = rot_pc(rot1, pts)
    pts2 = rot_pc(rot2, pts)
    loss_per_part = ((pts1 - pts2)**2).sum(-1).mean(-1)
    return _valid_mean(loss_per_part, valids)


def rot_points_cd_loss(pts, rot1, rot2, valids):
    """Per-part chamfer between differently rotated parts
    (JAX loss.py:80-91)."""
    pts1 = rot_pc(rot1, pts)
    pts2 = rot_pc(rot2, pts)
    dist1, dist2 = chamfer_diag(pts1, pts2, valids)  # [B, P, N]
    loss_per_part = dist1.mean(2) + dist2.mean(2)
    return _valid_mean(loss_per_part, valids)


def shape_cd_loss(pts, trans1, trans2, rot1, rot2, valids, training=True):
    """Whole-shape chamfer after posing all parts (JAX loss.py:94-122).

    training=True divides by the padded part count P; training=False by
    each shape's true part count.
    """
    B, P, N, _ = pts.shape
    pts = pts.detach()
    pts1 = transform_pc(trans1, rot1, pts)
    pts2 = transform_pc(trans2, rot2, pts)
    dist1, dist2 = chamfer_parts(pts1, pts2, valids)  # [B, P*N]

    valids_f = valids.to(dist1.dtype).detach()
    point_valids = valids_f.repeat_interleave(N, dim=1)
    dist1 = dist1 * point_valids
    dist2 = dist2 * point_valids
    if training:
        return dist1.mean(1) + dist2.mean(1)
    dist = (dist1 + dist2).reshape(B, P, N).mean(-1)
    return _valid_mean(dist, valids_f)


def repulsion_cd_matrix(part_pcs, dense_limit=2**27, *, plain=False):
    """[B, P, P] chamfer of every part against every part of the same shape,
    padded parts included (JAX loss.py:134-150).

    Up to `dense_limit` pair-distance elements, one `chamfer_distance` call
    on the broadcast [B*P*P, N, 3] clouds; past it, one call per part i
    against all parts ([B*P, N, 3] each), the loop that stands in for JAX's
    lax.scan.  Both give the same distances.  `plain=True` forces the plain
    version on a CUDA tensor.
    """
    B, P, N, _ = part_pcs.shape
    if B * P * P * N * N <= dense_limit:
        pts1 = part_pcs[:, :, None].expand(B, P, P, N, 3)
        pts2 = part_pcs[:, None, :].expand(B, P, P, N, 3)
        d1, d2 = chamfer_distance(pts1.reshape(B * P * P, N, 3),
                                  pts2.reshape(B * P * P, N, 3), plain=plain)
        return (d1.mean(1) + d2.mean(1)).reshape(B, P, P)
    flat = part_pcs.reshape(B * P, N, 3)
    rows = []
    for i in range(P):  # part i of every shape against all its parts
        tiled = part_pcs[:, i, None].expand(B, P, N, 3).reshape(B * P, N, 3)
        d1, d2 = chamfer_distance(tiled, flat, plain=plain)
        rows.append((d1.mean(1) + d2.mean(1)).reshape(B, P))
    return torch.stack(rows, 1)


def repulsion_cd_loss(part_pcs, valids, thre, dense_limit=2**27, *,
                      plain=False):
    """Chamfer repulsion pushing parts apart (JAX loss.py:125-154): the mean
    over valid part pairs of max(thre - cd, 0).  -> [B]"""
    cd = repulsion_cd_matrix(part_pcs, dense_limit, plain=plain)
    cd = torch.clamp(thre - cd, min=0.0)
    valid_mask = valids[:, :, None] * valids[:, None, :]
    return (cd * valid_mask).sum((1, 2)) / valid_mask.sum((1, 2))
