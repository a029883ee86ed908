"""Loss engine: the MoN (minimum-over-N) loss of one batch.

Port of multi_part_assembly_tpu/train/core.py:30-206.  The model's
precompute runs once; `sample_iter` samples follow in a loop (the JAX
package vmaps them), each from the same batch-norm running statistics, and
each batch element keeps its best sample.  Semantic assembly first matches
the ground truth of equivalent parts to each prediction (ops/matching.py),
one point subsample drawn for each supervised step of each sample.  Train
or eval mode is the model's own; `training` picks the loss semantics
(shape-CD divisor, eval metrics).
"""

import torch

from ..models.modules.norm import MaskedBatchNorm
from ..ops.matching import match_parts
from ..utils import tracing
from ..utils.eval_utils import (calc_connectivity_acc, calc_part_acc,
                                rot_metrics, trans_metrics)
from ..utils.loss import (rot_cosine_loss, rot_points_cd_loss,
                          rot_points_l2_loss, shape_cd_loss, trans_l2_loss)
from ..utils.rotation import Rotation3D

__all__ = ['calc_loss', 'loss_one_sample', 'mon_loss',
           'loss_weights_from_cfg']


def loss_weights_from_cfg(cfg_loss):
    """Loss name -> weight (JAX core.py:30-42)."""
    weights = {
        'trans_loss': cfg_loss.trans_loss_w,
        'rot_pt_cd_loss': cfg_loss.rot_pt_cd_loss_w,
        'transform_pt_cd_loss': cfg_loss.transform_pt_cd_loss_w,
    }
    if cfg_loss.get('use_rot_loss', False):
        weights['rot_loss'] = cfg_loss.rot_loss_w
    if cfg_loss.get('use_rot_pt_l2_loss', False):
        weights['rot_pt_l2_loss'] = cfg_loss.rot_pt_l2_loss_w
    return weights


def calc_loss(pred_rot_raw, pred_trans, data_dict, *, rot_type, semantic,
              training, use_rot_loss, use_rot_pt_l2_loss,
              with_metrics=False, generator=None, match_idx=None):
    """Losses (and, at eval, the metrics) of one prediction (JAX
    core.py:45-108).  Semantic data first matches the GT poses of
    equivalent parts to the prediction, its point subsample drawn from
    `generator`, or the next of the iterator `match_idx`; its eval metrics
    are part_acc and connectivity_acc, geometric data's part_acc and the
    translation and rotation errors.  Returns a dict of [B] tensors."""
    part_pcs = data_dict['part_pcs']
    valids = data_dict['part_valids']
    pred_rot = Rotation3D(pred_rot_raw, rot_type)
    new_trans = data_dict['part_trans'].detach()
    new_rot_raw = data_dict['part_rot_raw'].detach()
    if semantic:
        with tracing.region('matching', part_pcs.device):
            new_trans, new_rot_raw = match_parts(
                part_pcs, pred_trans, pred_rot.rot, new_trans, new_rot_raw,
                data_dict['match_ids'], rot_type, generator=generator,
                sample_idx=None if match_idx is None else next(match_idx))
    new_rot = Rotation3D(new_rot_raw, rot_type)

    loss_dict = {
        'trans_loss': trans_l2_loss(pred_trans, new_trans, valids),
        'rot_pt_cd_loss': rot_points_cd_loss(part_pcs, pred_rot, new_rot,
                                             valids),
        'transform_pt_cd_loss': shape_cd_loss(
            part_pcs, pred_trans, new_trans, pred_rot, new_rot, valids,
            training=semantic or training),
    }
    if use_rot_loss:
        loss_dict['rot_loss'] = rot_cosine_loss(pred_rot, new_rot, valids)
    if use_rot_pt_l2_loss:
        loss_dict['rot_pt_l2_loss'] = rot_points_l2_loss(
            part_pcs, pred_rot, new_rot, valids)
    if with_metrics:
        loss_dict['part_acc'] = calc_part_acc(part_pcs, pred_trans, new_trans,
                                              pred_rot, new_rot, valids)
        if semantic:
            if 'contact_points' in data_dict:
                loss_dict['connectivity_acc'] = calc_connectivity_acc(
                    pred_trans, pred_rot, data_dict['contact_points'])
            return loss_dict
        for metric in ('mse', 'rmse', 'mae'):
            loss_dict[f'trans_{metric}'] = trans_metrics(
                pred_trans, new_trans, valids, metric)
            loss_dict[f'rot_{metric}'] = rot_metrics(
                pred_rot, new_rot, valids, metric)
    return loss_dict


def _bn_buffers(model):
    """The running-statistics buffers of every batch norm in `model`."""
    norms = (MaskedBatchNorm, torch.nn.modules.batchnorm._BatchNorm)
    return [b for m in model.modules() if isinstance(m, norms)
            for b in m.buffers(recurse=False)]


def loss_one_sample(pred, data_dict, **kw):
    """Losses of one sample; a multi-step prediction [T, B, P, ...] sums its
    steps and logs each as `{k}_{i}` (JAX core.py:111-140).  The device
    region `loss` (utils/tracing.py)."""
    rot, trans = tracing.region_begin('loss', pred['rot'], pred['trans'])
    if trans.dim() != 4:
        all_loss = calc_loss(rot, trans, data_dict, **kw)
    else:
        all_loss = {}
        for i in range(trans.shape[0]):
            ld = calc_loss(rot[i], trans[i], data_dict, **kw)
            for k, v in ld.items():
                all_loss[k] = all_loss.get(k, 0.0) + v
                all_loss[f'{k}_{i}'] = v
    return dict(zip(all_loss, tracing.region_end('loss',
                                                 *all_loss.values())))


def mon_loss(model, data_dict, *, cfg, training, reduce=True,
             generator=None, match_idx=None):
    """Minimum-over-N loss (JAX core.py:143-206).

    Returns (scalar loss, log dict).  Logs are batch means, or per-element
    [B] vectors with reduce=False (eval slices off padding rows before
    averaging).  BatchNorm running statistics update in place when the
    model is in train mode: `precompute`'s update, then the mean of the
    samples' updates.  Semantic data draws each sample's noise, then one
    match subsample for each supervised step, from `generator`;
    `match_idx`, a list of index tensors, gives the subsamples instead,
    sample by sample and step by step.
    """
    semantic = cfg.data.dataset != 'geometry'
    sample_iter = cfg.loss.get('sample_iter', 1)
    rot_type = cfg.model.rot_type
    weights = loss_weights_from_cfg(cfg.loss)

    data_dict = dict(data_dict)
    data_dict['part_rot_raw'] = Rotation3D(
        data_dict['part_quat'], 'quat').convert(rot_type).rot
    kw = dict(rot_type=rot_type, semantic=semantic, training=training,
              use_rot_loss=cfg.loss.get('use_rot_loss', False),
              use_rot_pt_l2_loss=cfg.loss.get('use_rot_pt_l2_loss', False),
              with_metrics=not training, generator=generator,
              match_idx=None if match_idx is None else iter(match_idx))

    feats = model.precompute(data_dict)
    # Train-mode BN in `sample` updates the running statistics.  The
    # original torch repo ran the samples one after another, each updating
    # them in turn; the JAX package, which the port is held against, starts
    # every sample from the statistics after `precompute` and keeps the mean
    # of the samples' updates (JAX core.py:169-185, 200-204).  One sample
    # needs no snapshot: its update is the mean.
    buffers = _bn_buffers(model) if model.training and sample_iter > 1 \
        else []
    start = [b.clone() for b in buffers]
    updates = [[] for _ in buffers]
    samples = []
    for _ in range(sample_iter):
        samples.append(loss_one_sample(
            model.sample(feats, data_dict, generator), data_dict, **kw))
        with torch.no_grad():
            for b, s, u in zip(buffers, start, updates):
                u.append(b.clone())
                b.copy_(s)
    with torch.no_grad():
        for b, u in zip(buffers, updates):
            if b.is_floating_point():
                b.copy_(torch.stack(u).mean(0))
            else:  # a batch counter: one step, as one sample leaves it
                b.copy_(u[-1])
    loss_dicts = {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
    loss_dicts['loss'] = sum(loss_dicts[k] * w for k, w in weights.items())

    # per-element argmin over the samples (JAX core.py:190-198)
    min_idx = loss_dicts['loss'].argmin(0)  # [B]
    rows = torch.arange(min_idx.shape[0], device=min_idx.device)
    log_dict = {k: v[min_idx, rows] for k, v in loss_dicts.items()}
    if reduce:
        log_dict = {k: v.mean() for k, v in log_dict.items()}
        return log_dict['loss'], log_dict
    return log_dict['loss'].mean(), log_dict
