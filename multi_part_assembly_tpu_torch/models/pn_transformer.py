"""PN-Transformer and its iterative-refinement variant (port of
multi_part_assembly_tpu/models/pn_transformer.py:18-150): PointNet encoder
-> transformer correlator -> stochastic pose head.  Submodules are named as
in the torch reference (`enc`, `corr`, `head`)."""

import torch
from torch import nn

from .base import extract_part_feats, rot_dim_of, zero_pose
from .modules.encoders import build_encoder
from .modules.regressor import StochasticPoseRegressor
from .modules.transformer import TransformerEncoder

__all__ = ['PNTransformer', 'PNTransformerRefine']


class PNTransformer(nn.Module):

    def __init__(self, rot_type='quat', pc_feat_dim=256,
                 encoder_arch='pointnet', noise_dim=0,
                 transformer_feat_dim=1024, transformer_heads=8,
                 transformer_layers=4, transformer_pre_ln=True,
                 label_dim=0, compute_dtype=torch.float32):
        super().__init__()
        self.enc = build_encoder(encoder_arch, pc_feat_dim,
                                 compute_dtype=compute_dtype)
        self.corr = TransformerEncoder(
            d_model=pc_feat_dim, num_heads=transformer_heads,
            ffn_dim=transformer_feat_dim, num_layers=transformer_layers,
            norm_first=transformer_pre_ln, compute_dtype=compute_dtype)
        self.head = StochasticPoseRegressor(
            pc_feat_dim + label_dim, noise_dim, rot_type=rot_type,
            compute_dtype=compute_dtype)

    def precompute(self, data_dict):
        part_valids = data_dict['part_valids']
        pc_feats = extract_part_feats(self.enc, data_dict['part_pcs'],
                                      part_valids)
        corr_feats = self.corr(pc_feats, part_valids > 0)  # [B, P, C]
        feats = torch.cat([corr_feats, data_dict['part_label'],
                           data_dict['instance_label']], dim=-1)
        return {'pre_pose_feats': feats}

    def sample(self, feats, data_dict, generator=None):
        rot, trans = self.head(feats['pre_pose_feats'], generator)
        return {'rot': rot, 'trans': trans}

    def forward(self, data_dict, generator=None):
        return self.sample(self.precompute(data_dict), data_dict, generator)


class _PosEncoder(nn.Module):
    """Learned pose positional encoding: Linear-ReLU stacks of `dims`, no
    ReLU after the last, in f32 (JAX pn_transformer.py:60-69)."""

    def __init__(self, in_dim, dims):
        super().__init__()
        layers = []
        for i, d in enumerate(dims):
            layers.append(nn.Linear(in_dim if i == 0 else dims[i - 1], d))
            if i < len(dims) - 1:
                layers.append(nn.ReLU())
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class PNTransformerRefine(nn.Module):
    """PN-Transformer with `refine_steps` clones of the correlator and the
    head; each step's pose feeds the next as an additive positional
    encoding of its part features (JAX pn_transformer.py:72-150).  Train
    mode returns every step's pose stacked [T, B, P, .], all supervised;
    eval mode the last."""

    def __init__(self, rot_type='quat', pc_feat_dim=128,
                 encoder_arch='pointnet', noise_dim=0,
                 transformer_feat_dim=512, transformer_heads=8,
                 transformer_layers=2, transformer_pre_ln=True,
                 transformer_pos_enc=(128, 128), pose_pc_feat=True,
                 refine_steps=3, label_dim=0, compute_dtype=torch.float32):
        super().__init__()
        self.rot_type = rot_type
        self.pose_pc_feat = pose_pc_feat
        pose_dim = rot_dim_of(rot_type) + 3
        self.enc = build_encoder(encoder_arch, pc_feat_dim,
                                 compute_dtype=compute_dtype)
        self.corr = nn.ModuleList([
            TransformerEncoder(
                d_model=pc_feat_dim, num_heads=transformer_heads,
                ffn_dim=transformer_feat_dim, num_layers=transformer_layers,
                norm_first=transformer_pre_ln, compute_dtype=compute_dtype,
                out_dim=pc_feat_dim)
            for _ in range(refine_steps)])
        head_in = pc_feat_dim * (2 if pose_pc_feat else 1) + label_dim + \
            pose_dim
        self.head = nn.ModuleList([
            StochasticPoseRegressor(head_in, noise_dim, rot_type=rot_type,
                                    compute_dtype=compute_dtype)
            for _ in range(refine_steps)])
        self.corr_pos_enc = _PosEncoder(pose_dim, tuple(transformer_pos_enc))

    def precompute(self, data_dict):
        return {'pc_feats': extract_part_feats(
            self.enc, data_dict['part_pcs'], data_dict['part_valids'])}

    def sample(self, feats, data_dict, generator=None):
        pc_feats = feats['pc_feats']
        valid = data_dict['part_valids'] > 0
        B, P, _ = pc_feats.shape
        zp = zero_pose(self.rot_type, pc_feats.dtype, pc_feats.device)
        pose = zp.expand(B, P, zp.shape[0])
        part_feats = pc_feats
        pred_rot, pred_trans = [], []
        for corr, head in zip(self.corr, self.head):
            corr_feats = corr(part_feats + self.corr_pos_enc(pose), valid)
            f = [corr_feats, data_dict['part_label'],
                 data_dict['instance_label'], pose]
            if self.pose_pc_feat:
                f = [pc_feats] + f
            rot, trans = head(torch.cat(f, dim=-1), generator)
            pred_rot.append(rot)
            pred_trans.append(trans)
            pose = torch.cat([rot, trans], dim=-1)
            part_feats = corr_feats
        if self.training:  # every step supervised (JAX :145-147)
            return {'rot': torch.stack(pred_rot),
                    'trans': torch.stack(pred_trans)}
        return {'rot': pred_rot[-1], 'trans': pred_trans[-1]}

    def forward(self, data_dict, generator=None):
        return self.sample(self.precompute(data_dict), data_dict, generator)
