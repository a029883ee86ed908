"""Plain PyTorch forward of the PN-Transformer (PointNet encoder, pre-LN
transformer over the parts, stochastic pose head), from a dict of named
leaves, in the compute type that the configuration's precision switch
states (`exp.bf16`, defined by the JAX package's `utils/precision.py`:
bf16 compute with f32 parameters and f32 normalisation statistics; its
batch norm applies factor and offset in the compute type, norm.py:127):
the values its matmuls, batch norms and activations produce rounded to
bf16, f32 elsewhere (`Precision`), or, for the control, in fp8 (the same
values rounded to e4m3, one scale a tensor).  The backward runs in f32
through the roundings.

The names are the torch reference repository's (`enc.conv1.weight`,
`corr.transformer_encoder.layers.0.self_attn.in_proj_weight`, ...), the
layout in which the benchmark hands both sides the same initial weights.

The encoder runs over the valid parts only: batch norm over the valid
clouds' points is what the padded batch's masked batch norm computes, and
padded parts have zero features.  The transformer runs over every slot, as
the padded tokens decide the shapes of its dropout masks.

Dropout: the masks come from the default generator of the device, drawn by
`torch.nn.functional.dropout` on a tensor of ones of the shape and the
compute type of the activation it masks, in the order of the forward, so
that a run seeded like the program's draws the program's masks.
"""

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8(x):
    """x rounded to e4m3 under one scale (its largest magnitude at 448),
    the gradient passed straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def bf16(x):
    """x rounded to bf16, the gradient passed straight through."""
    return x + (x.detach().to(torch.bfloat16).float() - x.detach())


ROUND = {'f32': lambda x: x, 'bf16': bf16, 'fp8': fp8}


class Precision:
    """The compute type: where the configuration computes in it, the
    forward rounds to it: every matmul's operands and result, the batch
    norm's scale, shift and output, the attention's scaled queries,
    softmax and masks, the head's activations; everything else is f32.
    'bf16' is the configurations' own (`exp.bf16`), 'f32' rounds nowhere,
    'fp8' rounds to e4m3 (the control)."""

    def __init__(self, name='f32'):
        if name not in ROUND:
            raise ValueError(f'precision: one of {sorted(ROUND)}, got '
                             f'{name!r}')
        self.name = name
        self.r = ROUND[name]

    def linear(self, x, w, b=None):
        y = torch.matmul(self.r(x), self.r(w).t())
        return self.r(y if b is None else y + self.r(b))

    def einsum(self, eq, a, b):
        return self.r(torch.einsum(eq, self.r(a), self.r(b)))


class Dropout:
    """Masks of rate p drawn from the device's default generator."""

    def __init__(self, p, mask_dtype, enabled=True):
        self.p = p
        self.mask_dtype = mask_dtype
        self.enabled = enabled and p > 0

    def __call__(self, x, prec):
        if not self.enabled:
            return x
        ones = torch.ones(x.shape, dtype=self.mask_dtype, device=x.device)
        out = F.dropout(ones, self.p, training=True)
        if x.device.type == 'cuda':  # the fused kernel scales in f32
            return prec.r(x * (out != 0) / (1.0 - self.p))
        return prec.r(x * out.float())  # the CPU's scale is of the mask's type


def batch_norm(x, w, b, prec, eps=1e-5):
    """Train-mode batch norm over every axis but the last, biased
    variance, as x * scale + shift."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    var = ((x - mean) ** 2).mean(dims)
    scale = w / torch.sqrt(var + eps)
    return prec.r(prec.r(x * prec.r(scale)) + prec.r(b - mean * scale))


def pointnet(params, pcs, prec, prefix='enc'):
    """[M, N, 3] clouds -> [M, C]: five pointwise layers, each with batch
    norm, ReLU after the first four, max over the points."""
    x = prec.r(pcs)
    for i in range(1, 6):
        w = params[f'{prefix}.conv{i}.weight'][:, :, 0]
        x = prec.linear(x, w)
        x = batch_norm(x, params[f'{prefix}.bn{i}.weight'],
                       params[f'{prefix}.bn{i}.bias'], prec)
        if i < 5:
            x = torch.relu(x)
    return x.amax(1)


def layer_norm(x, params, name):
    return F.layer_norm(x, x.shape[-1:], params[f'{name}.weight'],
                        params[f'{name}.bias'], 1e-5)


def transformer(params, x, valid, heads, layers, prec, drop,
                prefix='corr.transformer_encoder'):
    """Pre-LN encoder over [B, T, C] tokens, keys of invalid tokens masked,
    then the final LayerNorm."""
    B, T, C = x.shape
    hd = C // heads
    for li in range(layers):
        p = f'{prefix}.layers.{li}'
        h = layer_norm(x, params, f'{p}.norm1')
        qkv = prec.linear(h, params[f'{p}.self_attn.in_proj_weight'],
                          params[f'{p}.self_attn.in_proj_bias'])
        q, k, v = qkv.reshape(B, T, 3, heads, hd).unbind(2)
        q = prec.r(q / math.sqrt(hd))
        logits = prec.einsum('bqhd,bkhd->bhqk', q, k)
        logits = logits.masked_fill(~valid[:, None, None, :],
                                    torch.finfo(torch.float32).min)
        attn = drop(prec.r(logits.softmax(-1)), prec)
        out = prec.einsum('bhqk,bkhd->bqhd', attn, v).reshape(B, T, C)
        out = prec.linear(out, params[f'{p}.self_attn.out_proj.weight'],
                          params[f'{p}.self_attn.out_proj.bias'])
        x = x + drop(out, prec)
        h = layer_norm(x, params, f'{p}.norm2')
        h = torch.relu(prec.linear(h, params[f'{p}.linear1.weight'],
                                   params[f'{p}.linear1.bias']))
        h = prec.linear(drop(h, prec), params[f'{p}.linear2.weight'],
                        params[f'{p}.linear2.bias'])
        x = x + drop(h, prec)
    return layer_norm(x, params, f'{prefix}.norm')


def pose_head(params, feats, prec, prefix='head'):
    """feat -> 256 -> 128 (LeakyReLU 0.2) -> unit quaternion, translation."""
    f = prec.r(F.leaky_relu(prec.linear(
        feats, params[f'{prefix}.fc_layers.0.weight'],
        params[f'{prefix}.fc_layers.0.bias']), 0.2))
    f = prec.r(F.leaky_relu(prec.linear(
        f, params[f'{prefix}.fc_layers.2.weight'],
        params[f'{prefix}.fc_layers.2.bias']), 0.2))
    rot = f @ params[f'{prefix}.rot_head.weight'].t() + \
        params[f'{prefix}.rot_head.bias']
    rot = rot / torch.clamp(torch.linalg.norm(rot, dim=-1, keepdim=True),
                            min=1e-12)
    trans = f @ params[f'{prefix}.trans_head.weight'].t() + \
        params[f'{prefix}.trans_head.bias']
    return rot, trans


class PNTransformer:
    """`precompute(batch)` -> per-part features shared by the MoN samples;
    `sample(feats, generator)` -> (quat, trans), drawing the head's noise
    [B, P, noise_dim] from `generator` when noise_dim > 0."""

    def __init__(self, params, cfg, prec, dropout=0.1):
        self.params = params
        m = cfg['model']
        self.heads = int(m['transformer_heads'])
        self.layers = int(m['transformer_layers'])
        self.noise_dim = int(cfg['loss']['noise_dim'])
        self.prec = prec
        mask_dtype = torch.bfloat16 if cfg['exp'].get('bf16', True) \
            else torch.float32
        self.drop = Dropout(dropout, mask_dtype)

    def precompute(self, batch):
        pcs, valids = batch['part_pcs'], batch['part_valids']
        B, P = valids.shape
        valid = valids > 0
        enc = pointnet(self.params, pcs[valid], self.prec)
        feats = enc.new_zeros((B, P, enc.shape[-1]))
        feats[valid] = enc
        corr = transformer(self.params, feats, valid, self.heads,
                           self.layers, self.prec, self.drop)
        return torch.cat([corr, batch['part_label'],
                          batch['instance_label']], -1)

    def sample(self, feats, generator):
        if self.noise_dim > 0:
            noise = torch.randn(feats.shape[:-1] + (self.noise_dim, ),
                                generator=generator, device=feats.device)
            feats = torch.cat([feats, noise], -1)
        return pose_head(self.params, feats, self.prec)
