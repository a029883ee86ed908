"""Sampled assemblies and their PLY export (port of
multi_part_assembly_tpu/train/vis_utils.py:22-63).  The MoN noise comes
from a torch.Generator instead of JAX keys."""

import os

import numpy as np
import torch

from ..utils.misc import colorize_part_pc, save_pc, to_numpy
from ..utils.rotation import Rotation3D
from ..utils.transforms import transform_pc

__all__ = ['sample_assembly', 'export_assembly_samples']


@torch.no_grad()
def sample_assembly(model, data_dict, generator=None, *, rot_type,
                    sample_iter=1):
    """`sample_iter` predicted assemblies and the GT one, the model in the
    mode it is in.  Returns (gt_pcs [B, P, N, 3], list of predicted pcs)."""
    gt_rot = Rotation3D(data_dict['part_quat'], 'quat').convert(rot_type)
    part_pcs = data_dict['part_pcs']
    gt_pcs = transform_pc(data_dict['part_trans'], gt_rot, part_pcs)
    data = dict(data_dict)
    data['part_rot_raw'] = gt_rot.rot
    feats = model.precompute(data)
    preds = []
    for _ in range(sample_iter):
        out = model.sample(feats, data, generator)
        preds.append(transform_pc(out['trans'],
                                  Rotation3D(out['rot'], rot_type),
                                  part_pcs))
    return gt_pcs, preds


def export_assembly_samples(gt_pcs, pred_pcs_list, valids, colors, out_dir,
                            prefix='val', max_shapes=5):
    """Colored PLYs: the GT and each prediction of every shape, its valid
    parts only.  Returns the number of shapes written."""
    os.makedirs(out_dir, exist_ok=True)
    gt = to_numpy(gt_pcs)
    valids = to_numpy(valids)
    colors = np.asarray(colors)
    preds = [to_numpy(p) for p in pred_pcs_list]
    n = min(max_shapes, gt.shape[0])
    for b in range(n):
        p = int(valids[b].sum())
        save_pc(colorize_part_pc(gt[b, :p], colors).reshape(-1, 6),
                os.path.join(out_dir, f'{prefix}_shape{b}_gt.ply'))
        for s, pred in enumerate(preds):
            save_pc(colorize_part_pc(pred[b, :p], colors).reshape(-1, 6),
                    os.path.join(out_dir, f'{prefix}_shape{b}_pred{s}.ply'))
    return n
