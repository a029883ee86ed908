"""Identity baseline: always predicts the identity pose (port of
multi_part_assembly_tpu/models/identity.py:12-32)."""

import torch
from torch import nn

from .base import rot_dim_of, zero_pose

__all__ = ['IdentityModel']


class IdentityModel(nn.Module):

    def __init__(self, rot_type='quat'):
        super().__init__()
        self.rot_type = rot_type
        # a parameter so that the optimizer has one, as in JAX; never used,
        # so it takes zero gradients and stays 0
        self.dummy = nn.Parameter(torch.zeros(1))

    def precompute(self, data_dict):
        return {}

    def sample(self, feats, data_dict, generator=None):
        part_pcs = data_dict['part_pcs']
        B, P = part_pcs.shape[:2]
        zp = zero_pose(self.rot_type, part_pcs.dtype, part_pcs.device)
        rd = rot_dim_of(self.rot_type)
        return {'rot': zp[:rd].expand(B, P, rd),
                'trans': zp[rd:].expand(B, P, 3)}

    def forward(self, data_dict, generator=None):
        return self.sample(self.precompute(data_dict), data_dict, generator)
