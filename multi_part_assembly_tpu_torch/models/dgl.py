"""DGL: dynamic graph learning assembly model (port of
multi_part_assembly_tpu/models/dgl.py:23-219).

Equivalence classes of parts are dense masked reductions over the [B, P, P]
equality matrix, as in JAX.  The pair MLPs (the model's FLOP bulk), the
RelationNet and the pose encoder run their matmuls in `compute_dtype`; batch
norm statistics stay f32.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .base import extract_part_feats, rot_dim_of, zero_pose
from .modules.encoders import build_encoder
from .modules.norm import MaskedBatchNorm
from .modules.regressor import StochasticPoseRegressor

__all__ = ['DGLModel', 'RelationNet', 'PoseEncoder', 'EdgeMLP', 'NodeMLP',
           'merge_equiv_nodes']


def _linear(x, layer, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class NodeMLP(nn.Module):
    """MLP4: in -> 512 -> 512 -> F, each a linear and a batch norm over
    every row, padded rows included (JAX dgl.py:45-60), ReLU after the
    first two and, with `final_relu`, after the last (RGL-Net's has none)."""

    def __init__(self, in_dim, feat_dim, final_relu=True,
                 compute_dtype=torch.float32):
        super().__init__()
        self.final_relu = final_relu
        self.compute_dtype = compute_dtype
        dims = (in_dim, 512, 512, feat_dim)
        for i in range(1, 4):
            setattr(self, f'conv{i}', nn.Linear(dims[i - 1], dims[i]))
            setattr(self, f'bn{i}', MaskedBatchNorm(dims[i]))

    def forward(self, x):
        x = x.to(self.compute_dtype)
        for i in range(1, 4):
            x = _linear(x, getattr(self, f'conv{i}'), self.compute_dtype)
            x = getattr(self, f'bn{i}')(x, None)
            if i < 3 or self.final_relu:
                x = F.relu(x)
        return x.float()


class EdgeMLP(NodeMLP):
    """MLP3 over the [B, P, P] pair features, its batch norms over all pairs
    with no mask (JAX dgl.py:23-42)."""

    def __init__(self, in_dim, feat_dim, compute_dtype=torch.float32):
        super().__init__(in_dim, feat_dim, final_relu=True,
                         compute_dtype=compute_dtype)


class RelationNet(nn.Module):
    """Pairwise pose feature -> sigmoid relation weight (JAX
    dgl.py:63-74)."""

    def __init__(self, in_dim, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mlp1 = nn.Linear(in_dim, 256)
        self.mlp2 = nn.Linear(256, 512)
        self.mlp3 = nn.Linear(512, 1)

    def forward(self, x):
        cdt = self.compute_dtype
        x = F.relu(_linear(x, self.mlp1, cdt))
        x = F.relu(_linear(x, self.mlp2, cdt))
        return torch.sigmoid(_linear(x, self.mlp3, cdt).float())


class PoseEncoder(nn.Module):
    """pose -> 256 -> 128 features (JAX dgl.py:77-86)."""

    def __init__(self, in_dim, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mlp1 = nn.Linear(in_dim, 256)
        self.mlp2 = nn.Linear(256, 128)

    def forward(self, x):
        cdt = self.compute_dtype
        x = F.relu(_linear(x, self.mlp1, cdt))
        return F.relu(_linear(x, self.mlp2, cdt)).float()


def merge_equiv_nodes(feats, part_ids, valids):
    """Max-pool features among equivalent parts: parts i, j are equivalent
    iff they share `part_ids` and both are valid; a part is always its own
    class (JAX dgl.py:89-101)."""
    P = feats.shape[1]
    eq = (part_ids[:, :, None] == part_ids[:, None, :]) & \
        (valids[:, :, None] > 0) & (valids[:, None, :] > 0)
    eq = eq | torch.eye(P, dtype=torch.bool, device=feats.device)[None]
    neg = torch.full((), float('-inf'), dtype=feats.dtype,
                     device=feats.device)
    return torch.where(eq[..., None], feats[:, None, :, :], neg).amax(dim=2)


class DGLModel(nn.Module):
    """PointNet part features, then `gnn_iter` rounds of edge MLP messages
    weighted by a RelationNet over the predicted poses, a node update and a
    pose head each (JAX dgl.py:104-219).  Train mode returns every round's
    pose stacked [T, B, P, .], all supervised; eval mode the last."""

    def __init__(self, rot_type='quat', pc_feat_dim=128,
                 encoder_arch='pointnet', noise_dim=32, gnn_iter=3,
                 merge_node=True, semantic=True, label_dim=0,
                 compute_dtype=torch.float32):
        super().__init__()
        self.rot_type = rot_type
        self.pc_feat_dim = pc_feat_dim
        self.gnn_iter = gnn_iter
        self.merge_node = merge_node
        self.semantic = semantic
        self.compute_dtype = compute_dtype
        F_ = pc_feat_dim
        pose_dim = rot_dim_of(rot_type) + 3
        self.enc = build_encoder(encoder_arch, F_,
                                 compute_dtype=compute_dtype)
        self.edge_mlps = nn.ModuleList([
            EdgeMLP(2 * F_, F_, compute_dtype=compute_dtype)
            for _ in range(gnn_iter)])
        self.node_mlps = self._make_node_mlps(F_)
        self.pose_predictors = nn.ModuleList([
            StochasticPoseRegressor(F_ + label_dim + pose_dim, noise_dim,
                                    rot_type=rot_type,
                                    compute_dtype=compute_dtype)
            for _ in range(gnn_iter)])
        self.relation_dense = RelationNet(256, compute_dtype)
        if merge_node:
            self.relation_merge = RelationNet(256, compute_dtype)
        self.pose_extractor = PoseEncoder(pose_dim, compute_dtype)

    def _make_node_mlps(self, feat_dim):
        return nn.ModuleList([
            NodeMLP(2 * feat_dim, feat_dim, final_relu=True,
                    compute_dtype=self.compute_dtype)
            for _ in range(self.gnn_iter)])

    def precompute(self, data_dict):
        return {'part_feats': extract_part_feats(
            self.enc, data_dict['part_pcs'], data_dict['part_valids'])}

    def _update_relation(self, pose_feats, iter_ind):
        """RelationNet over the pairwise pose-feature concat [f_j, f_i] of
        pair (i, j); the merge net on odd rounds when merging (JAX
        dgl.py:137-150)."""
        B, P, C = pose_feats.shape
        pair = torch.cat([pose_feats[:, None, :, :].expand(B, P, P, C),
                          pose_feats[:, :, None, :].expand(B, P, P, C)],
                         dim=-1)
        net = self.relation_merge if self.merge_node and iter_ind % 2 == 1 \
            else self.relation_dense
        return net(pair)[..., 0]  # [B, P, P]

    def _message_passing(self, part_feats, relation_matrix, iter_ind):
        """Edge MLP over the pairs [f_i, f_j], relation-weighted mean over j
        (JAX dgl.py:153-166)."""
        B, P, C = part_feats.shape
        pair = torch.cat([part_feats[:, :, None, :].expand(B, P, P, C),
                          part_feats[:, None, :, :].expand(B, P, P, C)],
                         dim=-1)
        edge = self.edge_mlps[iter_ind](pair)  # [B, P, P, F]
        msg = (edge * relation_matrix[..., None]).sum(dim=2)
        norm = relation_matrix.sum(dim=-1, keepdim=True)
        return msg / (norm + 1e-6)

    def _node_update(self, part_feats, messages, valids, iter_ind,
                     generator):
        return self.node_mlps[iter_ind](
            torch.cat([messages, part_feats], dim=-1))

    def sample(self, feats, data_dict, generator=None):
        part_feats = feats['part_feats']
        valids = data_dict['part_valids']
        valid_matrix = data_dict['valid_matrix']
        labels = [data_dict['part_label'], data_dict['instance_label']]
        B, P, _ = part_feats.shape
        zp = zero_pose(self.rot_type, part_feats.dtype, part_feats.device)
        pred_pose = zp.expand(B, P, zp.shape[0])

        all_rot, all_trans = [], []
        for it in range(self.gnn_iter):
            if it >= 1:
                pose_feats = self.pose_extractor(pred_pose)
                if self.merge_node and self.semantic and it % 2 == 1:
                    part_ids = data_dict['part_ids']
                    part_feats_c = merge_equiv_nodes(part_feats, part_ids,
                                                     valids)
                    pose_feats_c = merge_equiv_nodes(pose_feats, part_ids,
                                                     valids)
                else:
                    part_feats_c, pose_feats_c = part_feats, pose_feats
                relation_matrix = self._update_relation(pose_feats_c, it) \
                    * valid_matrix
            else:
                part_feats_c = part_feats
                relation_matrix = valid_matrix
            messages = self._message_passing(part_feats_c, relation_matrix,
                                             it)
            part_feats = self._node_update(part_feats, messages, valids, it,
                                           generator)
            rot, trans = self.pose_predictors[it](
                torch.cat([part_feats, *labels, pred_pose], dim=-1),
                generator)
            pred_pose = torch.cat([rot, trans], dim=-1)
            all_rot.append(rot)
            all_trans.append(trans)

        if self.training:  # every round supervised (JAX dgl.py:213-216)
            return {'rot': torch.stack(all_rot),
                    'trans': torch.stack(all_trans)}
        return {'rot': all_rot[-1], 'trans': all_trans[-1]}

    def forward(self, data_dict, generator=None):
        return self.sample(self.precompute(data_dict), data_dict, generator)
