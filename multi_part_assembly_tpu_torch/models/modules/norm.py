"""Masked BatchNorm for fixed-shape padded batches.

Port of `MaskedBatchNorm` (multi_part_assembly_tpu/models/modules/norm.py:
44-175), sync statistics only (the per-replica groups wait for the
data-parallel port).  Train-mode statistics are moments weighted by the
validity mask, so a padded part never enters them: identical to BatchNorm
over the compacted valid parts.  It normalises with the biased variance and
tracks the unbiased one, as torch BatchNorm does.  Flax `momentum=0.9`
(norm.py:51) is torch `momentum=0.1` here.

`lean=True` (PointNet++'s grouped layers, [B, npoint, nsample, C]) takes
the train-mode moments through `_MaskedMoments`: the f32 passes run over
slices of the batch, and the backward is the closed form
w (g_mean + 2 g_var (x - mean)) / denom.  Autograd of the plain formulas
would keep three f32 copies of x for the backward, and the forward makes
three at once: a copy is 16 GB at MSG's widest grouped layer at batch 32.
The moments are the plain formulas', summed slice by slice.

Under `frozen_stats()` a train-mode layer normalises with its batch
statistics as always but leaves its running statistics alone: the
recompute of a checkpointed region (encoders.py `_SetAbstraction`) runs
under it, so that a train step updates them once, as JAX's `nn.remat`
does.
"""

import contextlib
import math

import torch
from torch import nn

__all__ = ['MaskedBatchNorm', 'frozen_stats']

_FROZEN = [False]


@contextlib.contextmanager
def frozen_stats():
    """Train-mode batch norms keep their running statistics inside."""
    prev, _FROZEN[0] = _FROZEN[0], True
    try:
        yield
    finally:
        _FROZEN[0] = prev


def _chunks(x, elements=2**28):
    """Slices of x's leading axis of about `elements` elements each."""
    step = max(1, elements * x.shape[0] // max(1, x.numel()))
    return [slice(i, i + step) for i in range(0, x.shape[0], step)]


def _rows(w, c):
    """w's rows c, or w itself when it does not vary along the leading
    axis."""
    return w[c] if w.dim() and w.shape[0] > 1 else w


class _MaskedMoments(torch.autograd.Function):
    """(mean, var) in f32 over every axis of x but the last, weighted by w
    (broadcastable to x), over `denom`.  The f32 passes run over slices of
    x's leading axis (`_chunks`), so no f32 copy of x exists at once; the
    backward keeps x and w only."""

    @staticmethod
    def forward(ctx, x, w, denom):
        dims = tuple(range(x.dim() - 1))
        parts = _chunks(x)
        mean = sum((x[c].float() * _rows(w, c)).sum(dims)
                   for c in parts) / denom
        var = sum((_rows(w, c) * (x[c].float() - mean)**2).sum(dims)
                  for c in parts) / denom
        ctx.save_for_backward(x, w, denom, mean)
        ctx.set_materialize_grads(False)
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, w, denom, mean = ctx.saved_tensors
        dx = torch.empty_like(x)
        for c in _chunks(x):
            g = 0.0 if g_mean is None else g_mean
            if g_var is not None:
                g = g + 2.0 * g_var * (x[c].float() - mean)
            dx[c] = ((_rows(w, c) / denom) * g).expand(dx[c].shape)
        return dx, None, None


class MaskedBatchNorm(nn.Module):
    """BatchNorm over every axis but the last (channel) one, weighted by an
    optional mask broadcastable to x's shape minus the channel axis."""

    def __init__(self, num_features, momentum=0.1, eps=1e-5, lean=False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.lean = lean
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x, mask=None, stats=None, affine_only=False):
        """Normalise x, or return the affine (factor, offset), each [C] f32,
        when `affine_only` (x then only gives the channel count).

        stats: (mean, var, denom) the caller computed ([C], [C], scalar,
            f32), used in train mode instead of x's moments; the running
            statistics update once from them (JAX norm.py:56-68,
            :129-136)."""
        if self.training:
            if stats is not None:
                mean, var, denom = stats
            elif self.lean:
                mean, var, denom = self._lean_moments(x, mask)
            else:
                mean, var, denom = self._moments(x, mask)
            if not _FROZEN[0]:
                with torch.no_grad():
                    var_track = var * denom / torch.clamp(denom - 1.0,
                                                          min=1.0)
                    m = self.momentum
                    self.running_mean.copy_(
                        (1.0 - m) * self.running_mean + m * mean)
                    self.running_var.copy_(
                        (1.0 - m) * self.running_var + m * var_track)
        else:
            mean, var = self.running_mean, self.running_var
        rstd = torch.rsqrt(var + self.eps)
        if affine_only:
            return self.weight * rstd, self.bias - mean * self.weight * rstd
        factor = (self.weight * rstd).to(x.dtype)
        offset = (self.bias - mean * self.weight * rstd).to(x.dtype)
        return x * factor + offset

    @staticmethod
    def _moments(x, mask):
        xs = x.float()  # statistics in f32, even for bf16 activations
        dims = tuple(range(x.dim() - 1))
        if mask is None:
            mean = xs.mean(dims)
            var = ((xs - mean)**2).mean(dims)
            denom = xs.new_tensor(float(math.prod(x.shape[:-1])))
        else:
            w = mask[..., None].float()
            fan = math.prod(xs.shape[:-1]) // math.prod(w.shape[:-1])
            denom = torch.clamp(w.sum() * fan, min=1.0)
            mean = (xs * w).sum(dims) / denom
            var = (w * (xs - mean)**2).sum(dims) / denom
        return mean, var, denom

    @staticmethod
    def _lean_moments(x, mask):
        if mask is None:
            w = x.new_ones((), dtype=torch.float32)
            denom = w.new_tensor(float(math.prod(x.shape[:-1])))
        else:
            w = mask[..., None].float()
            fan = math.prod(x.shape[:-1]) // math.prod(w.shape[:-1])
            denom = torch.clamp(w.sum() * fan, min=1.0)
        mean, var = _MaskedMoments.apply(x, w, denom)
        return mean, var, denom
