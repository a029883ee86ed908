"""The PointNet's global max-pool over each cloud's points, in f32, on CUDA
kernels (csrc/max_pool.cu).

Replaces no TPU kernel: the JAX package pools with
`jnp.max(x.astype(f32), axis=-2)` (multi_part_assembly_tpu/models/modules/
encoders.py `PointNet`), which XLA fuses.  Eager PyTorch ran the same
expression, `x.float().amax(-2)`, as five dense passes over the padded
bf16 activations [B, P, N, C]: the f32 copy and the max forward; autograd's
tie mask, its `long` count, the product and the cast of dx backward, 3.3 ms
of the flagship's 10.5 ms train step on an H100.  The bytes the work needs
take 0.29 ms at 3.35 TB/s: x read once forward, read once more and dx
written once backward.

Two routes compute the same function, `max_pool(x)` picks one:
  - the kernels (the autograd function `MaxPoolFn`): `mpa_max_pool_fwd`
    gives the max of each cloud's channel and how many points attain it;
    `mpa_max_pool_bwd` gives dx = (g / count) * (x == max), rounded once to
    x's type.  Bit for bit the plain version, forward and backward (the
    kernel source says how).
  - the plain version `max_pool_plain`, the CPU's, the expression the
    kernels replace, which autograd differentiates.
A CPU tensor takes the plain version; a CUDA tensor launches the kernels or
raises: they take bf16 or f32 clouds [..., N, C] of a multiple of 8
channels, at most MAX_POINTS points, made contiguous and 16-byte aligned
(`kernel_rows`), and nothing falls back.  Each launch counts
`launch.pool_fwd` or `launch.pool_bwd`.
"""

import math

import torch

from .cuda_build import launch, require
from .masked_bn import KERNEL_DTYPES, kernel_rows

__all__ = ['max_pool', 'max_pool_plain', 'max_pool_cuda',
           'max_pool_grad_cuda', 'MaxPoolFn']

# points a cloud the kernels take: their f32 tie counts stay exact
MAX_POINTS = 2**24


def max_pool_plain(x):
    """The max of x [..., N, C] over its points, f32 [..., C]."""
    return x.float().amax(dim=-2)


def _clouds(x):
    """(R, N, C, dtype code) of x [..., N, C]: contiguous, 16-byte aligned
    bf16 or f32 clouds of a multiple of 8 channels, 1 to MAX_POINTS
    points; else ValueError."""
    shape = tuple(x.shape)
    if not (x.dtype in KERNEL_DTYPES and x.dim() >= 2 and
            x.is_contiguous() and x.data_ptr() % 16 == 0 and
            shape[-1] > 0 and shape[-1] % 8 == 0 and
            0 < shape[-2] <= MAX_POINTS and math.prod(shape[:-2]) > 0):
        raise ValueError('x: expected contiguous, 16-byte aligned clouds '
                         '[..., N, C] of a multiple of 8 channels of '
                         f'{list(KERNEL_DTYPES)}, 1 to {MAX_POINTS} points; '
                         f'got {x.dtype} {shape}')
    return math.prod(shape[:-2]), shape[-2], shape[-1], KERNEL_DTYPES[x.dtype]


def max_pool_cuda(x):
    """Kernel `mpa_max_pool_fwd`: (out, count) of x [..., N, C]
    (`_clouds`): out f32 [..., C] the max over the points, count int32
    [..., C] how many points attain it (0 where the max is NaN)."""
    R, N, C, code = _clouds(x)
    out = torch.empty(x.shape[:-2] + (C, ), dtype=torch.float32,
                      device=x.device)
    count = torch.empty(out.shape, dtype=torch.int32, device=x.device)
    launch('mpa_max_pool_fwd', 'pool_fwd', x.device, x.data_ptr(), R, N, C,
           code, out.data_ptr(), count.data_ptr())
    return out, count


def max_pool_grad_cuda(x, out, count, g):
    """Kernel `mpa_max_pool_bwd`: dx of `max_pool_plain` at x given the
    gradient g of its output, from the forward's (out, count):
    (g / count) * (x == out) in f32, rounded once to x's type."""
    R, N, C, code = _clouds(x)
    want = x.shape[:-2] + (C, )
    for t, name, dtype in ((out, 'out', torch.float32),
                           (count, 'count', torch.int32),
                           (g, 'g', torch.float32)):
        require(t, name, dtype, want, x.device)
    dx = torch.empty_like(x)
    launch('mpa_max_pool_bwd', 'pool_bwd', x.device, x.data_ptr(),
           out.data_ptr(), count.data_ptr(), g.data_ptr(), R, N, C, code,
           dx.data_ptr())
    return dx


class MaxPoolFn(torch.autograd.Function):
    """`max_pool_plain` on the kernels.  Saves x (in its own type) and the
    [..., C] max and count: no f32 copy of x."""

    @staticmethod
    def forward(ctx, x):
        out, count = max_pool_cuda(x)
        ctx.save_for_backward(x, out, count)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, count = ctx.saved_tensors
        return max_pool_grad_cuda(x, out, count, g.contiguous())


def max_pool(x):
    """The max of x [..., N, C] over its points, f32 [..., C]: the kernels
    on a CUDA tensor (through a contiguous, aligned copy where x is not
    so), the plain version on the CPU."""
    if not x.is_cuda:
        return max_pool_plain(x)
    return MaxPoolFn.apply(kernel_rows(x))
