"""The first training steps of a run, by the plain reference: the batches
worked out again from the data files (reference/data.py), the model of
the configuration's family (reference/families/<model.name>.py, found by
name), the MoN loss (reference/loss.py), autograd, and Adam written out.

`run_steps` starts from the initial weights the benchmark made and follows
its own trajectory; it never reads the program's state.  It computes in
the configuration's compute type (`exp.bf16`); `precision='fp8'` is the
control, the same steps one type below.
`fault` plants one of the faults the comparison has to catch, for the
calibration of its limits: 'half' (the loss of half the batch, the mean
over the rest), 'scaled' (the first part of every shape scaled by 0.5
where its points are produced).
"""

import math

import torch

from . import data as D
from .families import family
from .loss import mon_loss
from .model import Precision

BETAS = (0.9, 0.999)
EPS = 1e-8


def lr_at(cfg, step, steps_per_epoch):
    """The learning rate of the `step`-th update (0-based): constant, or a
    cosine (or linear) decay over `num_epochs` after a linear warm-up of
    `warmup_ratio` of them, from lr / lr_decay_factor, at epoch
    granularity, one cycle."""
    o = cfg['optimizer']
    lr = float(o['lr'])
    kind = o.get('lr_scheduler') or None
    if kind is None:
        return lr
    total = int(cfg['exp']['num_epochs'])
    warm = int(total * float(o['warmup_ratio']))
    lo = lr / float(o['lr_decay_factor'])
    e = step // steps_per_epoch
    if e < warm:
        return (lr - lo) * e / warm + lo
    if kind == 'linear':
        e = min(e, total)
        return lo + (lr - lo) * (total - e) / (total - warm)
    return lo + (lr - lo) * 0.5 * (
        1.0 + math.cos(math.pi * (e - warm) / (total - warm)))


class Batches:
    """The program's first batches of epoch 0, worked out again."""

    def __init__(self, cfg, wire, seed, device):
        d = cfg['data']
        self.cfg, self.wire, self.device = cfg, wire, device
        self.semantic = d['dataset'] != 'geometry'
        fn = d['data_fn'].format('train')
        if self.semantic:
            self.items = D.partnet_items(d['data_dir'], fn,
                                         int(d['min_num_part']),
                                         int(d['max_num_part']))
        else:
            self.items = D.geometry_items(d['data_dir'], fn,
                                          int(d['min_num_part']),
                                          int(d['max_num_part']))
        self.batch_size = int(cfg['exp']['batch_size'])
        self.order = D.epoch_batches(len(self.items), self.batch_size,
                                     int(seed), 0)
        self.meshes = D.MeshCache()

    @property
    def steps_per_epoch(self):
        return len(self.order)

    def __call__(self, k):
        """Batch k of epoch 0, before augmentation."""
        idx = self.order[k]
        if self.semantic:
            return D.partnet_batch(self.items, idx, self.cfg, self.device)
        return D.geometry_batch(self.items, idx, 0, self.cfg, self.wire,
                                self.meshes, self.device)


def _plant(batch, fault):
    if fault == 'scaled':
        key = 'part_pcs_raw' if 'part_pcs_raw' in batch else 'part_pcs'
        batch = dict(batch)
        pcs = batch[key].clone()
        pcs[:, 0] *= 0.5
        batch[key] = pcs
    return batch


def run_steps(cfg, wire, params0, seed, steps, device, precision=None,
              fault=None):
    """`steps` steps from `params0` (name -> tensor).  Returns a dict:
    'loss' (a step's logs: each loss term and the loss, batch means),
    'grad' {name: step-1 gradient}, 'params' {name: weights after the
    steps}."""
    if cfg['optimizer'].get('weight_decay', 0.0):
        raise ValueError('the reference writes out Adam without weight '
                         'decay only')
    fam = family(cfg)
    fam.supported(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(int(seed))  # the dropout masks' default generator
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))    # augmentation, noise, subsamples
    batches = Batches(cfg, wire, seed, device)
    names = list(params0)
    leaves = {n: params0[n].detach().clone().to(device).requires_grad_()
              for n in names}
    m = {n: torch.zeros_like(v) for n, v in leaves.items()}
    v2 = {n: torch.zeros_like(v) for n, v in leaves.items()}
    if precision is None:  # the configuration's own
        precision = 'bf16' if cfg['exp'].get('bf16', True) else 'f32'
    model = fam.build(leaves, cfg, Precision(precision))
    losses, grad1 = [], None
    for k in range(steps):
        batch = _plant(batches(k), fault)
        if not batches.semantic:
            batch = D.augment(batch, gen)
        if fault == 'half':
            half = batch['part_valids'].shape[0] // 2
            batch = {key: t[:half] for key, t in batch.items()}
        loss, logs = mon_loss(model, batch, cfg, gen)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(names, grads)}
        losses.append({k: float(v.detach()) for k, v in logs.items()})
        if grad1 is None:
            grad1 = {n: g.detach().clone() for n, g in grads.items()}
        lr = lr_at(cfg, k, batches.steps_per_epoch)
        t = k + 1
        bc1, bc2 = 1.0 - BETAS[0] ** t, 1.0 - BETAS[1] ** t
        with torch.no_grad():
            for n in names:
                g = grads[n]
                m[n].mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                v2[n].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                denom = v2[n].sqrt() / math.sqrt(bc2) + EPS
                leaves[n].sub_(lr / bc1 * m[n] / denom)
    return {'loss': losses, 'grad': grad1,
            'params': {n: t.detach() for n, t in leaves.items()}}
