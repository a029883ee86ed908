"""Initial weights of a run, made on the device from the seed.

One `torch.rand` call on a generator of the device fills every leaf at
once, in f32, the type the weights are trained in: a matrix (two or more
axes) takes U(-b, b) with b = 1 / sqrt(fan_in), a one-axis `weight` (a
norm's scale) 1, any other one-axis leaf (a bias) U(-0.05, 0.05).  The
benchmark hands the same leaves, by name, to the program and to the
reference.
"""

import math

import torch

BIAS = 0.05
_SALT = 0x9e3779b97f4a7c15  # keeps the weights' stream apart from the run's


def make_weights(named_shapes, seed, device):
    """{name: tensor} for [(name, shape)] from `seed`."""
    total = sum(math.prod(s) for _, s in named_shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) ^ _SALT) & 0x7fffffffffffffff)
    u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, shape in named_shapes:
        n = math.prod(shape)
        x = u[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            out[name] = x * (1.0 / math.sqrt(n // shape[0]))
        elif name.endswith('weight'):
            out[name] = torch.ones_like(x)
        else:
            out[name] = x * BIAS
    return out


@torch.no_grad()
def load_weights(model, weights):
    """Copy `weights` into the model's parameters, in place."""
    for name, p in model.named_parameters():
        p.copy_(weights[name])
