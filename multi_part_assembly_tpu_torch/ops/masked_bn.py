"""Masked batch norm over channels-last rows, with the ReLU that follows
it, on CUDA kernels (csrc/masked_bn.cu).

Replaces no TPU kernel: the JAX package leaves its batch norm
(multi_part_assembly_tpu/models/modules/norm.py `MaskedBatchNorm`) to XLA,
which fuses it.  Eager PyTorch ran the same formulas as some ten passes a
direction over the activations, most of them in f32: 24.1 ms of the
flagship's 32.7 ms train step on an H100 (10.2 forward, 13.9 backward).
The bytes the work needs take 1.6 ms at 3.35 TB/s over its five PointNet
layers (640,000 rows of 64-256 bf16 channels, 32% of the clouds valid):
forward, a moments read of the valid clouds (0.24 GB) and a read-and-write
apply (1.47 GB); backward, a reduction read of dy and x (1.47 GB) and a
read-dy, read-x, write-dx pass (2.21 GB).

Two routes compute the same train-mode function (`models/modules/norm.py`
picks one):
  - the kernels, `masked_bn` (the autograd function `MaskedBatchNormFn`):
    `mpa_bn_moments` (the mean and biased variance over the rows of the
    valid groups, a group of weight 0 never read), the [C] expressions of
    `affine` in PyTorch, then `mpa_bn_apply` (the bf16 product and sum,
    each rounded, then the ReLU); its backward `mpa_bn_backward`, f32 from
    dy to dx with one rounding of dx (the kernel source says how).
  - the plain version, the CPU's and eval mode's: `moments_plain`,
    `affine` and `normalize_plain`, the arithmetic that autograd
    differentiates.
A CPU tensor takes the plain version; a CUDA tensor given to a kernel
launches it or raises: the kernels take contiguous, 16-byte aligned rows
(`kernel_rows` makes them so) of a multiple of 8 bf16 or f32 channels, at
most MAX_ROWS rows, and nothing falls back.  Each call of a kernel counts
`launch.bn_moments`, `launch.bn_apply` or `launch.bn_backward`: the first
and the last are each a reduction and the launch that finishes it (and
`bn_backward` the dx pass), `bn_apply` one.
"""

import math

import torch
import torch.nn.functional as F

from .cuda_build import launch, load_library, require

__all__ = ['masked_bn', 'MaskedBatchNormFn', 'moments_plain', 'affine',
           'normalize_plain', 'row_weights', 'kernel_rows',
           'moments_cuda', 'apply_cuda', 'backward_cuda']

# the kernels' activation types (csrc/masked_bn.cu's `dtype` codes)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# rows the kernels take: their f32 counts of rows stay exact integers
MAX_ROWS = 2**24


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------

def moments_plain(x, mask):
    """(mean, var, denom) in f32 over every axis of x but the last,
    weighted by mask (broadcastable to x.shape[:-1]) over denom =
    max(Σ mask, 1)."""
    xs = x.float()  # statistics in f32, even for bf16 activations
    dims = tuple(range(x.dim() - 1))
    if mask is None:
        mean = xs.mean(dims)
        var = ((xs - mean)**2).mean(dims)
        denom = torch.full((), float(math.prod(x.shape[:-1])),
                           dtype=xs.dtype, device=xs.device)
    else:
        w = mask[..., None].float()
        fan = math.prod(xs.shape[:-1]) // math.prod(w.shape[:-1])
        denom = torch.clamp(w.sum() * fan, min=1.0)
        mean = (xs * w).sum(dims) / denom
        var = (w * (xs - mean)**2).sum(dims) / denom
    return mean, var, denom


def affine(weight, bias, mean, var, eps):
    """(rstd, factor, offset), each [C] f32: x normalises to
    x * factor + offset."""
    rstd = torch.rsqrt(var + eps)
    return rstd, weight * rstd, bias - mean * weight * rstd


def normalize_plain(x, factor, offset, relu=False):
    """x * factor + offset in x's type (factor and offset rounded to it
    first), then the ReLU."""
    out = x * factor.to(x.dtype) + offset.to(x.dtype)
    return F.relu(out) if relu else out


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def row_weights(mask, shape):
    """(w, fan): a mask broadcastable to the rows shape[:-1] of a
    channels-last [..., C] x as the kernels take it, w [groups] f32 one
    weight a run of `fan` consecutive rows (the leading axes of x up to the
    mask's last axis that is not 1: a cloud's points share its weight);
    (None, rows) with no mask."""
    lead = tuple(shape[:-1])
    if mask is None:
        return None, math.prod(lead)
    full = (1, ) * (len(lead) - mask.dim()) + tuple(mask.shape)
    if len(full) != len(lead) or \
            any(d not in (1, n) for d, n in zip(full, lead)):
        raise ValueError(f'mask: shape {tuple(mask.shape)} does not '
                         f'broadcast to the rows {lead}')
    k = max([i + 1 for i, d in enumerate(full) if d != 1], default=0)
    w = mask.reshape(full[:k]).expand(lead[:k]).reshape(-1)
    return w.float().contiguous(), math.prod(lead) // max(1, w.numel())


def kernel_rows(t):
    """t as the kernels read it: contiguous and 16-byte aligned (a copy
    where it is not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _rows(x):
    """(R, C, dtype code) of x: contiguous, 16-byte aligned rows of a
    multiple of 8 bf16 or f32 channels, 1 to MAX_ROWS of them; else
    ValueError."""
    C = x.shape[-1] if x.dim() else 0
    if not (x.dtype in KERNEL_DTYPES and x.is_contiguous() and C > 0 and
            C % 8 == 0 and 0 < x.numel() // C <= MAX_ROWS and
            x.data_ptr() % 16 == 0):
        raise ValueError('x: expected contiguous, 16-byte aligned rows of a '
                         f'multiple of 8 channels of {list(KERNEL_DTYPES)}, '
                         f'at most {MAX_ROWS} rows; got {x.dtype} '
                         f'{tuple(x.shape)}')
    return x.numel() // C, C, KERNEL_DTYPES[x.dtype]


def _ptr(t):
    return None if t is None else t.data_ptr()


def moments_cuda(x, w, fan):
    """Kernel `mpa_bn_moments`: (mean, var, denom) f32 of x's rows
    ([..., C], `_rows`) weighted by w ([R / fan] f32, or None for weight 1),
    the rows of a group of weight 0 never read."""
    R, C, code = _rows(x)
    if w is not None:
        require(w, 'w', torch.float32, (R // fan, ), x.device)
    parts = load_library().mpa_bn_parts(R, C)
    scratch = torch.empty(parts * (1 + 2 * C), dtype=torch.float32,
                          device=x.device)
    mean, var = (torch.empty(C, dtype=torch.float32, device=x.device)
                 for _ in range(2))
    denom = torch.empty((), dtype=torch.float32, device=x.device)
    launch('mpa_bn_moments', 'bn_moments', x.device, x.data_ptr(), _ptr(w),
           R, C, fan, code, scratch.data_ptr(), mean.data_ptr(),
           var.data_ptr(), denom.data_ptr())
    return mean, var, denom


def apply_cuda(x, factor, offset, relu):
    """Kernel `mpa_bn_apply`: x * factor + offset, the product and the sum
    each rounded to x's type, then the ReLU; factor and offset [C] in x's
    type."""
    R, C, code = _rows(x)
    require(factor, 'factor', x.dtype, (C, ), x.device)
    require(offset, 'offset', x.dtype, (C, ), x.device)
    y = torch.empty_like(x)
    launch('mpa_bn_apply', 'bn_apply', x.device, x.data_ptr(),
           factor.data_ptr(), offset.data_ptr(), y.data_ptr(), R, C, code,
           int(relu))
    return y


def backward_cuda(dy, x, factor, offset, w, fan, weight, mean, rstd, denom,
                  relu, need_dx=True):
    """Kernel `mpa_bn_backward`: (dx or None, dweight, dbias) of
    `apply_cuda(x, factor, offset, relu)` with factor and offset from
    `affine(weight, bias, mean, var, eps)`, mean, var and denom the moments
    of x under w (`moments_cuda`).  f32 throughout, dx rounded once to x's
    type."""
    R, C, code = _rows(x)
    require(dy, 'dy', x.dtype, x.shape, x.device)
    if dy.data_ptr() % 16:
        raise ValueError('dy: expected 16-byte aligned rows')
    for t, name in ((factor, 'factor'), (offset, 'offset')):
        require(t, name, x.dtype, (C, ), x.device)
    for t, name in ((weight, 'weight'), (mean, 'mean'), (rstd, 'rstd')):
        require(t, name, torch.float32, (C, ), x.device)
    require(denom, 'denom', torch.float32, (), x.device)
    if w is not None:
        require(w, 'w', torch.float32, (R // fan, ), x.device)
    parts = load_library().mpa_bn_parts(R, C)
    scratch = torch.empty(parts * 2 * C + 2 * C, dtype=torch.float32,
                          device=x.device)
    dweight, dbias = (torch.empty(C, dtype=torch.float32, device=x.device)
                      for _ in range(2))
    dx = torch.empty_like(x) if need_dx else None
    launch('mpa_bn_backward', 'bn_backward', x.device, dy.data_ptr(),
           x.data_ptr(), factor.data_ptr(), offset.data_ptr(), _ptr(w), fan,
           weight.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
           denom.data_ptr(), R, C, code, int(relu), scratch.data_ptr(),
           dweight.data_ptr(), dbias.data_ptr(), _ptr(dx))
    return dx, dweight, dbias


class MaskedBatchNormFn(torch.autograd.Function):
    """y = x * factor + offset on the kernels, then the ReLU, with
    (factor, offset) from `affine(weight, bias, mean, var, eps)`, mean, var
    and denom x's moments under w (train mode), the gradient flowing
    through them.  Saves x, w and [C] vectors: no f32 copy of x."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, relu, w, fan, denom):
        rstd, factor, offset = affine(weight, bias, mean, var, eps)
        factor, offset = factor.to(x.dtype), offset.to(x.dtype)
        ctx.save_for_backward(x, w, weight, mean, rstd, factor, offset,
                              denom)
        ctx.fan, ctx.relu = fan, relu
        return apply_cuda(x, factor, offset, relu)

    @staticmethod
    def backward(ctx, dy):
        x, w, weight, mean, rstd, factor, offset, denom = ctx.saved_tensors
        dx, dweight, dbias = backward_cuda(
            kernel_rows(dy), x, factor, offset, w, ctx.fan, weight, mean, rstd, denom,
            ctx.relu, need_dx=ctx.needs_input_grad[0])
        return dx, dweight, dbias, None, None, None, None, None, None, None


# masked_bn(x, weight, bias, mean, var, eps, relu, w, fan, denom): the
# kernels' train-mode batch norm of x [..., C] (CUDA, `_rows`) with the
# moments (mean, var, denom) = `moments_cuda(x, w, fan)`
masked_bn = MaskedBatchNormFn.apply
