"""Shared model plumbing (port of multi_part_assembly_tpu/models/base.py).

Models expose `precompute(data_dict)`, the deterministic feature path the
MoN samples share, and `sample(feats, data_dict, generator)`, the
stochastic path; `forward` is both.  Train or eval mode is the module's own
(`model.train()` / `model.eval()`).
"""

import torch

__all__ = ['extract_part_feats', 'rot_dim_of', 'zero_pose']


def rot_dim_of(rot_type):
    """Raw rotation-vector dim: quat=4, rmat=6 (the 6D head) (JAX
    base.py:24-30)."""
    if rot_type == 'quat':
        return 4
    if rot_type == 'rmat':
        return 6
    raise NotImplementedError(f'rotation {rot_type} is not supported')


def zero_pose(rot_type, dtype=torch.float32, device=None):
    """Identity pose vector [rot..., trans=0]: quat (1, 0, 0, 0), 6D
    (1, 0, 0, 0, 1, 0) (JAX base.py:33-43)."""
    rot = {'quat': [1.0, 0, 0, 0], 'rmat': [1.0, 0, 0, 0, 1.0, 0]}.get(
        rot_type)
    if rot is None:
        raise NotImplementedError(f'rotation {rot_type} is not supported')
    # filled on the device: a host constant cannot enter a captured graph
    pose = torch.zeros(len(rot) + 3, dtype=dtype, device=device)
    for i, v in enumerate(rot):
        if v:
            pose[i].fill_(v)
    return pose


def extract_part_feats(encoder, part_pcs, part_valids):
    """Encode every one of the B*P parts with shared weights; the validity
    mask drives the BN statistics and zeroes padded parts' features
    (JAX base.py:46-65).

    Args:
        part_pcs: [B, P, N, 3];  part_valids: [B, P]

    Returns: [B, P, C]
    """
    B, P, N, _ = part_pcs.shape
    flat_mask = part_valids.reshape(B * P)
    feats = encoder(part_pcs.reshape(B * P, N, 3), mask=flat_mask)
    feats = feats * flat_mask[:, None]
    return feats.reshape(B, P, -1)
