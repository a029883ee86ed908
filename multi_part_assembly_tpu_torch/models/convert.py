"""Carry weights from the JAX package into the port.

`jax_to_state_dict(variables, model)` turns the JAX model's {'params',
'batch_stats'} tree, with numpy (or array-like) leaves, into the port's
`state_dict()` of the same family (`model` is the config's model name,
default 'pn_transformer').  It is the inverse of the torch -> flax maps in
tests/test_golden_forward.py:50-120 and :178-232:
  - Dense kernels [in, out] become weight [out, in] ([out, in, 1] for the
    PointNet Conv1d layers);
  - q/k/v kernels [C, H, hd] pack into in_proj_weight [3C, C];
  - the out kernel [H, hd, C] becomes out_proj.weight [C, C];
  - BN scale/bias/mean/var become weight/bias/running_mean/running_var,
    LayerNorm scale/bias become weight/bias;
  - a FusedGRUCell keeps its fused wi [C, 3H] (merged r/z biases), wh
    [H, 3H] and bhn, transposed;
  - the pose head's rot_head is [4, 128] for quaternions and [6, 128] for
    the 6D head (`rot_type='rmat'`), as its kernel's shape gives it, and
    its first layer has the label columns of a semantic build
    (instance_label, part_label) and the noise columns the same way;
  - DGL / RGL-Net's per-round `edge_mlp{i}`, `node_mlp{i}`, `pose{i}` and
    `gru{i}`, and Refine's `corr{i}`, `pose{i}` and `corr_pos_enc`, become
    the port's ModuleLists.
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


def _pointnet(sd, key, p, stats):
    for i in range(1, 6):
        sd[f'{key}.conv{i}.weight'] = \
            _t(p[f'conv{i}']['kernel']).T[:, :, None].contiguous()
        _norm(sd, f'{key}.bn{i}', p[f'bn{i}'])
        _stats(sd, f'{key}.bn{i}', stats[f'bn{i}'])


def _stats(sd, key, s):
    sd[f'{key}.running_mean'] = _t(s['mean'])
    sd[f'{key}.running_var'] = _t(s['var'])


def _transformer(sd, key, corr):
    n_layers = sum(1 for k in corr if k.startswith('layer'))
    for i in range(n_layers):
        layer, lk = corr[f'layer{i}'], f'{key}.transformer_encoder.layers.{i}'
        _attention(sd, f'{lk}.self_attn', layer['self_attn'])
        for name in ('linear1', 'linear2'):
            _linear(sd, f'{lk}.{name}', layer[name])
        for name in ('norm1', 'norm2'):
            _norm(sd, f'{lk}.{name}', layer[name])
    if 'norm' in corr:
        _norm(sd, f'{key}.transformer_encoder.norm', corr['norm'])
    if 'out_fc' in corr:
        _linear(sd, f'{key}.out_fc', corr['out_fc'])


def _head(sd, key, p):
    head = p['head']
    _linear(sd, f'{key}.fc_layers.0', head['fc1'])
    _linear(sd, f'{key}.fc_layers.2', head['fc2'])
    _linear(sd, f'{key}.rot_head', head['rot_head'])
    _linear(sd, f'{key}.trans_head', head['trans_head'])


def _gru_cell(sd, key, p):
    _linear(sd, f'{key}.wi', p['wi'])
    sd[f'{key}.wh.weight'] = _t(p['wh']['kernel']).T.contiguous()
    sd[f'{key}.bhn'] = _t(p['bhn'])


def _gru(sd, key, p):
    for cell, cp in p.items():  # l{layer}_d{dir}
        _gru_cell(sd, f'{key}.{cell}', cp)


def _mlp34(sd, key, p, stats):
    for i in range(1, 4):
        _linear(sd, f'{key}.conv{i}', p[f'conv{i}'])
        _norm(sd, f'{key}.bn{i}', p[f'bn{i}'])
        _stats(sd, f'{key}.bn{i}', stats[f'bn{i}'])


def _pn_transformer(params, stats, sd):
    _pointnet(sd, 'enc', params['encoder'], stats['encoder'])
    _transformer(sd, 'corr', params['corr_module'])
    _head(sd, 'head', params['pose_predictor'])


def _refine(params, stats, sd):
    _pointnet(sd, 'enc', params['encoder'], stats['encoder'])
    steps = sum(1 for k in params if k.startswith('corr') and k[4:].isdigit())
    for i in range(steps):
        _transformer(sd, f'corr.{i}', params[f'corr{i}'])
        _head(sd, f'head.{i}', params[f'pose{i}'])
    pos = params['corr_pos_enc']
    for i in range(len(pos)):  # fc{i} -> Sequential index 2i
        _linear(sd, f'corr_pos_enc.layers.{2 * i}', pos[f'fc{i}'])


def _global(params, stats, sd):
    _pointnet(sd, 'enc', params['encoder'], stats['encoder'])
    _pointnet(sd, 'global_enc', params['global_encoder'],
              stats['global_encoder'])
    _head(sd, 'head', params['pose_predictor'])


def _seq2seq(sd, key, p):
    _gru(sd, f'{key}.encoder', p['encoder'])
    dec = p['decoder']
    for cell in ('cell0', 'cell1'):
        _gru_cell(sd, f'{key}.decoder.{cell}', dec[cell])
    for name in ('lin1a', 'lin1b', 'lin3a', 'lin3b'):
        _linear(sd, f'{key}.decoder.{name}', dec[name])


def _lstm(params, stats, sd):
    _pointnet(sd, 'enc', params['encoder'], stats['encoder'])
    _seq2seq(sd, 'seq2seq', params['seq2seq'])
    _head(sd, 'head', params['pose_predictor'])


def _dgl(params, stats, sd):
    _pointnet(sd, 'enc', params['encoder'], stats['encoder'])
    iters = sum(1 for k in params if k.startswith('edge_mlp'))
    for i in range(iters):
        _mlp34(sd, f'edge_mlps.{i}', params[f'edge_mlp{i}'],
               stats[f'edge_mlp{i}'])
        _mlp34(sd, f'node_mlps.{i}', params[f'node_mlp{i}'],
               stats[f'node_mlp{i}'])
        _head(sd, f'pose_predictors.{i}', params[f'pose{i}'])
        if f'gru{i}' in params:  # RGL-Net
            _gru(sd, f'grus.{i}', params[f'gru{i}'])
    for name in ('relation_dense', 'relation_merge'):
        if name in params:
            for k in ('mlp1', 'mlp2', 'mlp3'):
                _linear(sd, f'{name}.{k}', params[name][k])
    for k in ('mlp1', 'mlp2'):
        _linear(sd, f'pose_extractor.{k}', params['pose_extractor'][k])


def _identity(params, stats, sd):
    sd['dummy'] = _t(params['dummy'])


_FAMILIES = {
    'pn_transformer': _pn_transformer,
    'pn_transformer_refine': _refine,
    'global': _global,
    'lstm': _lstm,
    'dgl': _dgl,
    'rgl_net': _dgl,
    'identity': _identity,
}


def jax_to_state_dict(variables, model='pn_transformer'):
    """JAX variables of the `model` family -> the port's state_dict."""
    sd = {}
    _FAMILIES[model](variables['params'], variables.get('batch_stats', {}),
                     sd)
    return sd
