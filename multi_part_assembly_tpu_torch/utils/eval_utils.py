"""Evaluation metrics.

Port of multi_part_assembly_tpu/utils/eval_utils.py: part accuracy, the
connectivity accuracy over the dense [B, P, P] contact matrix, and the
translation and rotation (Euler degrees) errors.
"""

import torch

from ..ops.chamfer import chamfer_diag
from .loss import _valid_mean
from .transforms import transform_pc

__all__ = ['calc_part_acc', 'calc_connectivity_acc', 'trans_metrics',
           'rot_metrics']


def calc_part_acc(pts, trans1, trans2, rot1, rot2, valids):
    """Share of each shape's valid parts whose per-part chamfer after posing
    is below 0.01 (JAX eval_utils.py:22-32).  -> [B]"""
    pts1 = transform_pc(trans1, rot1, pts)
    pts2 = transform_pc(trans2, rot2, pts)
    dist1, dist2 = chamfer_diag(pts1, pts2, valids)  # [B, P, N]
    loss_per_part = dist1.mean(2) + dist2.mean(2)
    valid = valids == 1
    acc = (loss_per_part < 0.01) & valid
    return acc.sum(-1) / valid.sum(-1)


def calc_connectivity_acc(trans, rot, contact_points):
    """Connectivity accuracy (JAX eval_utils.py:35-84): each contact point
    pair, posed by the predicted poses of its two parts, is correct when
    the least distance over its 8 x 8 axis-mirror images is below 0.01.
    The mean is over every contact of the batch, tiled to [B].

    Args:
        trans: [B, P, 3]; rot: Rotation3D [B, P, ...];
        contact_points: [B, P, P, 4] (flag, then the point in part i's
        frame)
    """
    B = trans.shape[0]
    rot_type, r = rot.rot_type, rot.rot
    mask = contact_points[..., 0] == 1  # [B, P, P]
    p1 = contact_points[..., 1:]  # [B, P, P, 3]
    p2 = contact_points.transpose(1, 2)[..., 1:]  # the partner's (j, i)
    signs = torch.tensor(
        [[(-1.0)**x, (-1.0)**y, (-1.0)**z] for x in range(2)
         for y in range(2) for z in range(2)], dtype=contact_points.dtype,
        device=contact_points.device)  # [8, 3]
    sp1 = p1[..., None, :] * signs  # [B, P, P, 8, 3]
    sp2 = p2[..., None, :] * signs
    # part i's pose applies to p1[b, i, j], part j's to p2[b, i, j]
    t1 = trans[:, :, None, None, :].expand(sp1.shape)
    t2 = trans[:, None, :, None, :].expand(sp2.shape)
    if rot_type == 'quat':
        r1 = r[:, :, None, None, :].expand(sp1.shape[:-1] + (4, ))
        r2 = r[:, None, :, None, :].expand(sp2.shape[:-1] + (4, ))
    else:
        r1 = r[:, :, None, None].expand(sp1.shape[:-1] + (3, 3))
        r2 = r[:, None, :, None].expand(sp2.shape[:-1] + (3, 3))
    tp1 = transform_pc(t1, r1, sp1[..., None, :], rot_type=rot_type)[..., 0, :]
    tp2 = transform_pc(t2, r2, sp2[..., None, :], rot_type=rot_type)[..., 0, :]
    d = ((tp1[..., :, None, :] - tp2[..., None, :, :])**2).sum(-1)
    min_d = d.amin((-1, -2))  # [B, P, P]
    correct = (min_d < 0.01) & mask
    acc = correct.sum() / torch.clamp(mask.sum(), min=1)
    return torch.ones((B, ), dtype=trans.dtype, device=trans.device) * acc


def trans_metrics(trans1, trans2, valids, metric='rmse'):
    """Translation mse, rmse or mae (JAX eval_utils.py:87-96).  -> [B]"""
    assert metric in ['mse', 'rmse', 'mae']
    if metric == 'mse':
        per_part = ((trans1 - trans2)**2).mean(-1)
    elif metric == 'rmse':
        per_part = torch.sqrt(((trans1 - trans2)**2).mean(-1))
    else:
        per_part = (trans1 - trans2).abs().mean(-1)
    return _valid_mean(per_part, valids)


def rot_metrics(rot1, rot2, valids, metric='rmse'):
    """Rotation mse, rmse or mae on Euler degrees, the difference wrapped
    at 360 (JAX eval_utils.py:99-113).  -> [B]"""
    assert metric in ['mse', 'rmse', 'mae']
    deg1 = rot1.to_euler(to_degree=True)  # [B, P, 3]
    deg2 = rot2.to_euler(to_degree=True)
    diff1 = (deg1 - deg2).abs()
    diff = torch.minimum(diff1, 360.0 - diff1)
    if metric == 'mse':
        per_part = (diff**2).mean(-1)
    elif metric == 'rmse':
        per_part = torch.sqrt((diff**2).mean(-1))
    else:
        per_part = diff.mean(-1)
    return _valid_mean(per_part, valids)
