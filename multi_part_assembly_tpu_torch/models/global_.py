"""B-Global (port of multi_part_assembly_tpu/models/global_.py:15-51): a
shared part PointNet and a whole-shape PointNet feed a stochastic MLP pose
head.  Submodules are named as in the torch reference (`enc`,
`global_enc`, `head`)."""

import torch
from torch import nn

from .base import extract_part_feats
from .modules.encoders import build_encoder
from .modules.regressor import StochasticPoseRegressor

__all__ = ['GlobalModel']


class GlobalModel(nn.Module):

    def __init__(self, rot_type='quat', pc_feat_dim=128,
                 encoder_arch='pointnet', noise_dim=32, label_dim=0,
                 compute_dtype=torch.float32):
        super().__init__()
        self.pc_feat_dim = pc_feat_dim
        self.enc = build_encoder(encoder_arch, pc_feat_dim,
                                 compute_dtype=compute_dtype)
        self.global_enc = build_encoder(encoder_arch, pc_feat_dim,
                                        compute_dtype=compute_dtype)
        self.head = StochasticPoseRegressor(
            2 * pc_feat_dim + label_dim, noise_dim, rot_type=rot_type,
            compute_dtype=compute_dtype)

    def precompute(self, data_dict):
        part_pcs = data_dict['part_pcs']
        B, P, N, _ = part_pcs.shape
        pc_feats = extract_part_feats(self.enc, part_pcs,
                                      data_dict['part_valids'])
        # whole-shape feature over every point, the padded zeros included,
        # in the BN statistics too (JAX global_.py:37-41)
        global_feats = self.global_enc(part_pcs.reshape(B, P * N, 3),
                                       mask=None)
        global_feats = global_feats[:, None, :].expand(B, P,
                                                       self.pc_feat_dim)
        feats = torch.cat([global_feats, pc_feats, data_dict['part_label'],
                           data_dict['instance_label']], dim=-1)
        return {'pre_pose_feats': feats}

    def sample(self, feats, data_dict, generator=None):
        rot, trans = self.head(feats['pre_pose_feats'], generator)
        return {'rot': rot, 'trans': trans}

    def forward(self, data_dict, generator=None):
        return self.sample(self.precompute(data_dict), data_dict, generator)
