"""Carry PN-Transformer weights from the JAX package into the port.

`jax_to_state_dict` turns the JAX model's {'params', 'batch_stats'} tree,
with numpy (or array-like) leaves, into a `PNTransformer.state_dict()`.
It is the inverse of the torch -> flax maps in
tests/test_golden_forward.py:50-120:
  - Dense kernels [in, out] become weight [out, in] ([out, in, 1] for the
    PointNet Conv1d layers);
  - q/k/v kernels [C, H, hd] pack into in_proj_weight [3C, C];
  - the out kernel [H, hd, C] becomes out_proj.weight [C, C];
  - BN scale/bias/mean/var become weight/bias/running_mean/running_var,
    LayerNorm scale/bias become weight/bias;
  - the pose head's rot_head is [4, 128] for quaternions and [6, 128] for
    the 6D head (`rot_type='rmat'`), as its kernel's shape gives it.
"""

import numpy as np
import torch

__all__ = ['jax_to_state_dict']


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, key, p):
    sd[f'{key}.weight'] = _t(p['kernel']).T.contiguous()
    sd[f'{key}.bias'] = _t(p['bias'])


def _norm(sd, key, p):
    sd[f'{key}.weight'] = _t(p['scale'])
    sd[f'{key}.bias'] = _t(p['bias'])


def _attention(sd, key, p):
    C = np.shape(p['query']['kernel'])[0]
    w = [_t(p[n]['kernel']).reshape(C, C).T for n in ('query', 'key', 'value')]
    b = [_t(p[n]['bias']).reshape(C) for n in ('query', 'key', 'value')]
    sd[f'{key}.in_proj_weight'] = torch.cat(w, 0).contiguous()
    sd[f'{key}.in_proj_bias'] = torch.cat(b, 0)
    sd[f'{key}.out_proj.weight'] = \
        _t(p['out']['kernel']).reshape(C, C).T.contiguous()
    sd[f'{key}.out_proj.bias'] = _t(p['out']['bias'])


def jax_to_state_dict(variables):
    """JAX PNTransformer variables -> the port's PNTransformer state_dict."""
    params, stats = variables['params'], variables['batch_stats']
    sd = {}
    enc, enc_stats = params['encoder'], stats['encoder']
    for i in range(1, 6):
        sd[f'enc.conv{i}.weight'] = \
            _t(enc[f'conv{i}']['kernel']).T[:, :, None].contiguous()
        _norm(sd, f'enc.bn{i}', enc[f'bn{i}'])
        sd[f'enc.bn{i}.running_mean'] = _t(enc_stats[f'bn{i}']['mean'])
        sd[f'enc.bn{i}.running_var'] = _t(enc_stats[f'bn{i}']['var'])

    corr = params['corr_module']
    n_layers = sum(1 for k in corr if k.startswith('layer'))
    for i in range(n_layers):
        layer, key = corr[f'layer{i}'], f'corr.transformer_encoder.layers.{i}'
        _attention(sd, f'{key}.self_attn', layer['self_attn'])
        for name in ('linear1', 'linear2'):
            _linear(sd, f'{key}.{name}', layer[name])
        for name in ('norm1', 'norm2'):
            _norm(sd, f'{key}.{name}', layer[name])
    if 'norm' in corr:
        _norm(sd, 'corr.transformer_encoder.norm', corr['norm'])

    head = params['pose_predictor']['head']
    _linear(sd, 'head.fc_layers.0', head['fc1'])
    _linear(sd, 'head.fc_layers.2', head['fc2'])
    _linear(sd, 'head.rot_head', head['rot_head'])
    _linear(sd, 'head.trans_head', head['trans_head'])
    return sd
