"""Plain PyTorch MoN loss of the assembly task: the pose losses of each
sample, the per-shape minimum over the samples, the batch mean.

Chamfer distances are squared nearest-neighbour distances, found a block
of rows at a time without a gradient and then recomputed, differentiably,
to the found neighbours (so the memory of a whole-shape chamfer of 20,000
points stays a block's).  Semantic matching permutes the ground truth of
equivalent parts by an exact linear assignment of a 100-point subsample's
chamfer costs (`scipy.optimize.linear_sum_assignment`).
"""

import numpy as np
import torch

BLOCK = 4096  # query rows a block
PART_CHUNK = 32  # parts a block of the per-part chamfer
BIG = 1e9


def _identity_padded(q):
    """Quaternions of (near) zero norm, padded parts, -> identity."""
    iden = torch.zeros_like(q)
    iden[..., 0] = 1.0
    return torch.where((q * q).sum(-1, keepdim=True) > 0.25, q, iden)


def qrot(q, p):
    """Points [..., N, 3] turned by quaternions [..., 4]:
    p + 2 w (v x p) + 2 v x (v x p)."""
    q = q[..., None, :].expand(p.shape[:-1] + (4, ))
    w, v = q[..., :1], q[..., 1:]
    c1 = torch.linalg.cross(v, p, dim=-1)
    c2 = torch.linalg.cross(v, c1, dim=-1)
    return p + 2.0 * (w * c1 + c2)


def nearest(x, y):
    """Index in y [M, 3] of the nearest point of each x [Q, 3] row."""
    with torch.no_grad():
        out = []
        for i in range(0, x.shape[0], BLOCK):
            out.append(torch.cdist(x[i:i + BLOCK].double(),
                                   y.double()).argmin(1))
        return torch.cat(out)


def chamfer(x, y):
    """(d1 [Q], d2 [M]): squared distance of each point to the other
    cloud."""
    d1 = ((x - y[nearest(x, y)]) ** 2).sum(-1)
    d2 = ((y - x[nearest(y, x)]) ** 2).sum(-1)
    return d1, d2


def valid_mean(per_part, valids):
    return (per_part * valids).sum(1) / valids.sum(1)


def losses(pcs, valids, pred_q, pred_t, gt_q, gt_t, *, use_rot_loss,
           use_rot_pt_l2):
    """Per-shape [B] losses of one prediction; `pcs` [B, P, N, 3] are the
    augmented part clouds."""
    B, P, N, _ = pcs.shape
    pred_q, gt_q = _identity_padded(pred_q), _identity_padded(gt_q)
    out = {'trans_loss': valid_mean(((pred_t - gt_t) ** 2).sum(-1), valids)}
    r1, r2 = qrot(pred_q, pcs), qrot(gt_q, pcs)
    valid = valids > 0
    # per part, part i against part i, a chunk of parts at a time
    a, b = r1[valid], r2[valid]  # [M, N, 3]
    diag = []
    for i in range(0, a.shape[0], PART_CHUNK):
        x, y = a[i:i + PART_CHUNK], b[i:i + PART_CHUNK]
        with torch.no_grad():
            d = torch.cdist(x.double(), y.double())
            i1, i2 = d.argmin(2), d.argmin(1)
        d1 = ((x - y.gather(1, i1[..., None].expand(x.shape))) ** 2).sum(-1)
        d2 = ((y - x.gather(1, i2[..., None].expand(y.shape))) ** 2).sum(-1)
        diag.append(d1.mean(1) + d2.mean(1))
    per_part = pcs.new_zeros((B, P))
    per_part[valid] = torch.cat(diag)
    # the whole shape, its parts posed; the clouds carry no gradient here
    t1 = qrot(pred_q, pcs.detach()) + pred_t[:, :, None]
    t2 = qrot(gt_q, pcs.detach()) + gt_t[:, :, None]
    shape_cd = []
    for s in range(B):
        n = int(valids[s].sum())
        d1, d2 = chamfer(t1[s, :n].reshape(-1, 3), t2[s, :n].reshape(-1, 3))
        # the padded points count as zeros in the mean over P * N
        shape_cd.append((d1.sum() + d2.sum()) / (P * N))
    shape_cd = torch.stack(shape_cd)
    out['rot_pt_cd_loss'] = valid_mean(per_part, valids)
    out['transform_pt_cd_loss'] = shape_cd
    if use_rot_loss:
        out['rot_loss'] = valid_mean(
            1.0 - torch.abs((pred_q * gt_q).sum(-1)), valids)
    if use_rot_pt_l2:
        out['rot_pt_l2_loss'] = valid_mean(
            ((r1 - r2) ** 2).sum(-1).mean(-1), valids)
    return out


@torch.no_grad()
def match(pcs, pred_q, pred_t, gt_q, gt_t, match_ids, idx):
    """Ground-truth rows permuted within groups of equivalent parts to the
    least chamfer cost of the subsample `idx` of each part's points."""
    B, P = match_ids.shape
    pts = pcs[:, :, idx]
    a = qrot(_identity_padded(pred_q), pts) + pred_t[:, :, None]
    b = qrot(_identity_padded(gt_q), pts) + gt_t[:, :, None]
    d = torch.cdist(a.double().reshape(B, P, 1, -1, 3).expand(B, P, P, -1, 3)
                    .reshape(B * P * P, -1, 3),
                    b.double().reshape(B, 1, P, -1, 3).expand(B, P, P, -1, 3)
                    .reshape(B * P * P, -1, 3)) ** 2
    cost = (d.amin(2).mean(1) + d.amin(1).mean(1)).reshape(B, P, P)
    mid = match_ids.long()
    grouped = mid > 0
    block = (mid[:, :, None] == mid[:, None, :]) & grouped[:, :, None]
    cost = torch.where(block, cost, torch.full_like(cost, BIG))
    eye = torch.eye(P, dtype=torch.bool, device=cost.device)[None]
    cost = torch.where(eye & ~grouped[:, :, None], torch.zeros_like(cost),
                       cost).cpu().numpy()
    from scipy.optimize import linear_sum_assignment
    perm = np.stack([linear_sum_assignment(c)[1] for c in cost])
    perm = torch.from_numpy(perm).to(pcs.device)
    return (gt_q.gather(1, perm[..., None].expand(B, P, 4)),
            gt_t.gather(1, perm[..., None].expand(B, P, 3)))


def loss_weights(cfg):
    """Loss term -> its weight in the loss."""
    lc = cfg['loss']
    weights = {'trans_loss': lc['trans_loss_w'],
               'rot_pt_cd_loss': lc['rot_pt_cd_loss_w'],
               'transform_pt_cd_loss': lc['transform_pt_cd_loss_w']}
    if lc.get('use_rot_loss', False):
        weights['rot_loss'] = lc['rot_loss_w']
    if lc.get('use_rot_pt_l2_loss', False):
        weights['rot_pt_l2_loss'] = lc['rot_pt_l2_loss_w']
    return weights


def mon_loss(model, batch, cfg, generator):
    """(loss, logs): `sample_iter` samples from one precompute; the best
    sample a shape by its weighted loss; the logs are each loss term of the
    best samples and the loss, batch means.  A sample's poses are one
    prediction [B, P, .] or one a supervised iteration [T, B, P, .], whose
    terms add up over T.  On semantic data each prediction is matched
    first: the sample's noise, then a match subsample for each of its
    predictions in turn, drawn from `generator`."""
    lc = cfg['loss']
    semantic = cfg['data']['dataset'] != 'geometry'
    weights = loss_weights(cfg)
    pcs, valids = batch['part_pcs'], batch['part_valids']
    N = pcs.shape[2]

    def supervised(q, t):
        gt_q, gt_t = batch['part_quat'], batch['part_trans']
        if semantic:
            idx = torch.randperm(N, generator=generator,
                                 device=pcs.device)[:100]
            gt_q, gt_t = match(pcs, q, t, gt_q, gt_t, batch['match_ids'],
                               idx)
        return losses(pcs, valids, q, t, gt_q, gt_t,
                      use_rot_loss='rot_loss' in weights,
                      use_rot_pt_l2='rot_pt_l2_loss' in weights)

    feats = model.precompute(batch)
    totals, terms = [], []
    for _ in range(int(lc.get('sample_iter', 1))):
        q, t = model.sample(feats, generator)
        if t.dim() == 4:  # [T, B, P, .]: the terms summed over T
            ls = {}
            for qi, ti in zip(q, t):
                for k, v in supervised(qi, ti).items():
                    ls[k] = ls[k] + v if k in ls else v
        else:
            ls = supervised(q, t)
        totals.append(sum(ls[k] * w for k, w in weights.items()))
        terms.append(ls)
    totals = torch.stack(totals)  # [S, B]
    best = totals.argmin(0)
    rows = torch.arange(totals.shape[1], device=totals.device)
    logs = {k: torch.stack([t[k] for t in terms])[best, rows].mean()
            for k in weights}
    loss = totals[best, rows].mean()
    logs['loss'] = loss
    return loss, logs
