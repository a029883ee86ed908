"""Optimizer construction (port of multi_part_assembly_tpu/train/state.py:
38-50): Adam, or AdamW with biases and normalisation parameters excluded
from decay when `weight_decay > 0`, and optional global-norm clipping.
A capturable optimizer (the CUDA graph's, train/step.py) keeps its step
counts on the device and reads its lr from one device scalar, which
`set_lr` fills before each step."""

import torch

from .schedules import build_lr_schedule

__all__ = ['build_optimizer', 'decays', 'clip_gradients', 'set_lr']


def decays(name):
    """Whether a parameter takes weight decay: not biases, not norm layers
    (JAX utils/misc.py:97-118 `wd_param_mask`)."""
    parts = name.lower().split('.')
    if parts[-1].endswith('bias'):
        return False
    return not any('norm' in p or p.startswith('bn') for p in parts[:-1])


def build_optimizer(cfg, steps_per_epoch, model, capturable=False):
    """Returns (optimizer, schedule); the caller sets each step's lr from
    schedule(step) with `set_lr`, as optax evaluates its schedule at the
    update count.  `capturable` (CUDA parameters only) builds the optimizer
    with `capturable=True` and its lr as one f32 device scalar that every
    group shares."""
    schedule = build_lr_schedule(cfg, steps_per_epoch)
    lr = schedule(0)
    kw = {}
    if capturable:
        device = next(model.parameters()).device
        lr = torch.tensor(lr, dtype=torch.float32, device=device)
        kw['capturable'] = True
    wd = cfg.optimizer.weight_decay
    named = list(model.named_parameters())
    if wd > 0.0:
        groups = [
            {'params': [p for n, p in named if decays(n)],
             'weight_decay': wd},
            {'params': [p for n, p in named if not decays(n)],
             'weight_decay': 0.0},
        ]
        opt = torch.optim.AdamW(groups, lr=lr, **kw)
    else:
        opt = torch.optim.Adam([p for _, p in named], lr=lr, **kw)
    return opt, schedule


def clip_gradients(cfg, model):
    """Global-norm clipping when `cfg.optimizer.clip_grad` is set."""
    clip = cfg.optimizer.get('clip_grad', None)
    if clip:
        torch.nn.utils.clip_grad_norm_(model.parameters(), clip)


def set_lr(optimizer, lr):
    """Every group's lr: a float, or, on a capturable optimizer, the value
    filled into its device scalar (rounded to f32), without a host
    synchronisation."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group['lr']):
            group['lr'].fill_(lr)
        else:
            group['lr'] = lr
