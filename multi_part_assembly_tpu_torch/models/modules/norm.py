"""Masked BatchNorm for fixed-shape padded batches.

Port of `MaskedBatchNorm` (multi_part_assembly_tpu/models/modules/norm.py:
44-175).  Train-mode statistics are moments weighted by the validity mask,
so a padded part never enters them: identical to BatchNorm over the
compacted valid parts.  It normalises with the biased variance and
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

Data parallelism (parallel/dist.py): with more than one rank, a layer
whose `sync` is True (`cfg.exp.sync_bn`, the default; `build_model` sets
it) takes its train-mode moments over the global batch, in JAX's two
passes (norm.py:137-155): the sums of w x and of w are all-reduced, then
the sum of w (x - mean)^2.  The all-reduces are differentiable
(`all_reduce_sum`), so each rank's gradient carries the other ranks'
terms, as torch `SyncBatchNorm` does; the lean path all-reduces in its
forward and in its closed-form backward.  With `sync` False each rank
normalises with its own moments, and the running statistics track the
mean over the ranks of their (mean, unbiased variance), as JAX's
per-replica groups do (norm.py:117-121), so every rank keeps the same
ones.  Injected statistics are the caller's to reduce; they override
per-replica mode with a warning, as in JAX (norm.py:79-86).  With one
rank nothing is reduced and the numerics are those above, bit for bit.

Two routes, picked by the function a call asks for (`MaskedBatchNorm.route`),
never by its layout: on a CUDA tensor, train mode on one rank or per
replica computes its moments and applies them, with the ReLU that follows
where `relu`, on the kernels of csrc/masked_bn.cu (x made contiguous and
aligned, the mask one weight a run of consecutive rows; a type, channel
count or row count the kernels do not take raises, ops/masked_bn.py
`_rows`); eval mode, the lean layers, injected statistics, the affine
alone, sync BN over several ranks and the CPU take the plain PyTorch
arithmetic (ops/masked_bn.py `moments_plain`, `affine`,
`normalize_plain`).  The running statistics update from either route's
moments by the same expressions.  The kernels count their launches
(`launch.bn_moments`, ..., ops/cuda_build.py `launch`).
"""

import contextlib
import math
import warnings

import torch
from torch import nn

from ...ops import masked_bn as MB
from ...parallel.dist import all_reduce_, all_reduce_sum, world
from ...utils import tracing

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
    backward keeps x and w only.  With `sync` the sums are all-reduced over
    the ranks (`denom` is then the global one), and so are the cotangents
    of (mean, var) in the backward: the closed form holds for the global
    moments, since the weighted deviations from the global mean sum to
    zero over all ranks."""

    @staticmethod
    def forward(ctx, x, w, denom, sync=False):
        dims = tuple(range(x.dim() - 1))
        parts = _chunks(x)
        reduce = all_reduce_ if sync else (lambda t: t)
        mean = reduce(sum((x[c].float() * _rows(w, c)).sum(dims)
                          for c in parts)) / denom
        var = reduce(sum((_rows(w, c) * (x[c].float() - mean)**2).sum(dims)
                         for c in parts)) / denom
        ctx.save_for_backward(x, w, denom, mean)
        ctx.sync = sync
        ctx.set_materialize_grads(False)
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, w, denom, mean = ctx.saved_tensors
        if ctx.sync:  # every rank's loss depends on the global moments
            g = torch.cat([torch.zeros_like(mean) if t is None else t
                           for t in (g_mean, g_var)])
            g_mean, g_var = all_reduce_(g).chunk(2)
        dx = torch.empty_like(x)
        for c in _chunks(x):
            g = 0.0 if g_mean is None else g_mean
            if g_var is not None:
                g = g + 2.0 * g_var * (x[c].float() - mean)
            dx[c] = ((_rows(w, c) / denom) * g).expand(dx[c].shape)
        return dx, None, None, None


class MaskedBatchNorm(nn.Module):
    """BatchNorm over every axis but the last (channel) one, weighted by an
    optional mask broadcastable to x's shape minus the channel axis.  Each
    call is the device region `masked_bn` (utils/tracing.py)."""

    def __init__(self, num_features, momentum=0.1, eps=1e-5, lean=False,
                 sync=True):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.lean = lean
        self.sync = sync  # global moments across ranks (module docstring)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x, mask=None, stats=None, affine_only=False,
                relu=False):
        """Normalise x, then apply the ReLU when `relu`; or return the
        affine (factor, offset), each [C] f32, when `affine_only` (x then
        only gives the channel count).

        stats: (mean, var, denom) the caller computed ([C], [C], scalar,
            f32), used in train mode instead of x's moments; the running
            statistics update once from them (JAX norm.py:56-68,
            :129-136).  With several ranks they must be global."""
        x, = tracing.region_begin('masked_bn', x)
        out = self._normalize(x, mask, stats, affine_only, relu)
        if affine_only:
            return tracing.region_end('masked_bn', *out)
        out, = tracing.region_end('masked_bn', out)
        return out

    def route(self, x, stats=None, affine_only=False):
        """'fused' (the kernels compute the moments and apply them) or
        'plain' (the PyTorch arithmetic), from the function the call asks
        for: the kernels take train mode on a CUDA tensor with its own
        moments on one rank or per replica; eval mode, the lean layers,
        injected statistics, the affine alone and sync BN over several
        ranks stay plain."""
        if not x.is_cuda or not self.training or self.lean or \
                affine_only or stats is not None or \
                (self.sync and world() > 1):
            return 'plain'
        return 'fused'

    def _normalize(self, x, mask, stats, affine_only, relu):
        """`forward` without its marks."""
        route = self.route(x, stats, affine_only)
        if route == 'fused':
            x = MB.kernel_rows(x)
            w, fan = MB.row_weights(mask, x.shape)
        if self.training:
            ranks = world() > 1
            sync, replica = self.sync and ranks, not self.sync and ranks
            if stats is not None:
                if replica:
                    warnings.warn('MaskedBatchNorm: injected stats override '
                                  'the per-replica BN groups; using sync '
                                  'statistics')
                mean, var, denom = stats
            elif route == 'fused':
                mean, var, denom = MB.moments_cuda(x, w, fan)
            elif self.lean:
                mean, var, denom = self._lean_moments(x, mask, sync)
            elif sync:
                mean, var, denom = self._sync_moments(x, mask)
            else:
                mean, var, denom = MB.moments_plain(x, mask)
            if not _FROZEN[0]:
                with torch.no_grad():
                    mean_track = mean
                    var_track = var * denom / torch.clamp(denom - 1.0,
                                                          min=1.0)
                    if replica and stats is None:
                        # track the mean over the ranks of their moments
                        both = all_reduce_(torch.cat([mean, var_track]))
                        mean_track, var_track = (both / world()).chunk(2)
                    m = self.momentum
                    self.running_mean.copy_(
                        (1.0 - m) * self.running_mean + m * mean_track)
                    self.running_var.copy_(
                        (1.0 - m) * self.running_var + m * var_track)
        else:
            mean, var = self.running_mean, self.running_var
        if route == 'fused':
            return MB.masked_bn(x, self.weight, self.bias, mean, var,
                                self.eps, relu, w, fan, denom)
        _, factor, offset = MB.affine(self.weight, self.bias, mean, var,
                                      self.eps)
        if affine_only:
            return factor, offset
        return MB.normalize_plain(x, factor, offset, relu)

    @staticmethod
    def _sync_moments(x, mask):
        """`moments_plain` over the global batch: the sums of w x and of w
        all-reduced, then the sum of w (x - mean)^2, differentiably."""
        xs = x.float()
        dims = tuple(range(x.dim() - 1))
        if mask is None:
            w = xs.new_ones(())
            count = xs.new_tensor([float(math.prod(x.shape[:-1]))])
        else:
            w = mask[..., None].float()
            fan = math.prod(xs.shape[:-1]) // math.prod(w.shape[:-1])
            count = (w.sum() * fan).reshape(1)
        sums = all_reduce_sum(torch.cat([(xs * w).sum(dims), count]))
        denom = torch.clamp(sums[-1], min=1.0)
        mean = sums[:-1] / denom
        var = all_reduce_sum((w * (xs - mean)**2).sum(dims)) / denom
        return mean, var, denom

    @staticmethod
    def _lean_moments(x, mask, sync=False):
        if mask is None:
            w = x.new_ones((), dtype=torch.float32)
            count = torch.full((), float(math.prod(x.shape[:-1])),
                               dtype=w.dtype, device=w.device)
        else:
            w = mask[..., None].float()
            fan = math.prod(x.shape[:-1]) // math.prod(w.shape[:-1])
            count = w.sum() * fan
        if sync:
            count = all_reduce_(count.clone())
        denom = torch.clamp(count, min=1.0)
        mean, var = _MaskedMoments.apply(x, w, denom, sync)
        return mean, var, denom
