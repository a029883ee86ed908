"""Model factory (port of multi_part_assembly_tpu/models/__init__.py:28-77):
the seven families, each with any of the four encoders (`cfg.model.encoder`
pointnet, dgcnn, pointnet2_ssg or pointnet2_msg; Identity has none), on
geometric or semantic data."""

import torch

from .dgl import DGLModel
from .global_ import GlobalModel
from .identity import IdentityModel
from .lstm import LSTMModel
from .pn_transformer import PNTransformer, PNTransformerRefine
from .rgl_net import RGLNet

__all__ = ['build_model', 'label_dim_of', 'IdentityModel', 'GlobalModel',
           'LSTMModel', 'DGLModel', 'RGLNet', 'PNTransformer',
           'PNTransformerRefine']


def build_model(cfg, device='cuda'):
    """Instantiate the configured model on `device` ('cuda', 'cuda:N' or
    'cpu'): a CUDA device that is absent raises, the CPU is used only when
    asked for.  The weights are drawn on the CPU, so they do not depend on
    the device.  Matmuls run in bf16 unless `cfg.exp.bf16` is False (the
    JAX package's precision switch, utils/precision.py:34-37)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {str(device)!r} asked for, but no CUDA '
                           'device is available; pass the CPU explicitly')
    return _build(cfg).to(device)


def label_dim_of(cfg):
    """Width of the labels the pose heads read: instance_label's
    max_num_part, plus part_label's num_part_category when `data_keys` has
    it; 0 for geometric data, whose labels are empty."""
    if cfg.data.dataset == 'geometry':
        return 0
    return cfg.data.max_num_part + (
        cfg.data.num_part_category if 'part_label' in cfg.data.data_keys
        else 0)


def _build(cfg):
    name = cfg.model.name
    if name == 'identity':
        return IdentityModel(rot_type=cfg.model.rot_type)
    common = dict(
        rot_type=cfg.model.rot_type, pc_feat_dim=cfg.model.pc_feat_dim,
        encoder_arch=cfg.model.encoder, noise_dim=cfg.loss.noise_dim,
        label_dim=label_dim_of(cfg),
        compute_dtype=torch.bfloat16 if bool(cfg.exp.get('bf16', True))
        else torch.float32)
    if name == 'global':
        return GlobalModel(**common)
    if name == 'lstm':
        return LSTMModel(lstm_hidden_size=cfg.model.lstm_hidden_size,
                         **common)
    if name in ('dgl', 'rgl_net'):
        cls = DGLModel if name == 'dgl' else RGLNet
        return cls(gnn_iter=cfg.model.gnn_iter,
                   merge_node=cfg.model.merge_node,
                   semantic=cfg.data.dataset != 'geometry', **common)
    transformer = dict(
        transformer_feat_dim=cfg.model.transformer_feat_dim,
        transformer_heads=cfg.model.transformer_heads,
        transformer_layers=cfg.model.transformer_layers,
        transformer_pre_ln=cfg.model.transformer_pre_ln)
    if name == 'pn_transformer':
        return PNTransformer(**transformer, **common)
    if name == 'pn_transformer_refine':
        return PNTransformerRefine(
            transformer_pos_enc=tuple(cfg.model.transformer_pos_enc),
            pose_pc_feat=cfg.model.pose_pc_feat,
            refine_steps=cfg.model.refine_steps, **transformer, **common)
    raise NotImplementedError(f'model {name} is not supported')
