"""The port's MoN loss and batch norm in `sample`, held against the JAX
package's `mon_loss`.

A tiny model, written once in flax and once in torch, runs masked BN in
both `precompute` and `sample`; its sample appends Gaussian noise.  Both
packages get the same numpy weights, running statistics and batch, and the
torch model gets the noise the JAX run draws (the same `make_rng` call
under the keys `mon_loss` derives).  At `sample_iter` 1 and 3, in train
and eval mode, the losses and the running statistics after `mon_loss`
agree within 1e-6: every sample starts from the statistics `precompute`
left, and the statistics end as the mean of the samples' updates.  At
`sample_iter` 1 the flagship's `mon_loss` is bit for bit one precompute
and one sample.
"""

import copy
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multi_part_assembly_tpu.models.modules.norm import \
    MaskedBatchNorm as JaxBN
from multi_part_assembly_tpu.train.core import mon_loss as jax_mon_loss
from multi_part_assembly_tpu.utils import config_utils as JCFG
from multi_part_assembly_tpu_torch.models import build_model
from multi_part_assembly_tpu_torch.models.modules.norm import MaskedBatchNorm
from multi_part_assembly_tpu_torch.train.core import (
    loss_one_sample, loss_weights_from_cfg, mon_loss)
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, 'configs/pn_transformer/pn_transformer/'
                        'pn_transformer-32x1-cosine_400e-everyday.py')
B, P, N, H, D = 3, 4, 16, 8, 4   # batch, parts, points, width, noise
TOL = 1e-6


class JaxTiny(fnn.Module):
    """Masked BN in `precompute` (per point) and in `sample` (per part)."""

    def setup(self):
        self.enc = fnn.Dense(H)
        self.bn_pre = JaxBN()
        self.fc = fnn.Dense(H)
        self.bn_sample = JaxBN()
        self.head = fnn.Dense(7)

    def precompute(self, data_dict, train=True):
        valids = data_dict['part_valids']
        h = fnn.relu(self.enc(data_dict['part_pcs']))
        h = self.bn_pre(h, valids[..., None], train=train)
        return {'f': h.max(axis=2) * valids[..., None]}

    def noise(self, shape):
        return jax.random.normal(self.make_rng('noise'), shape)

    def sample(self, feats, data_dict, train=True):
        f = feats['f']
        z = jax.random.normal(self.make_rng('noise'), f.shape[:-1] + (D, ))
        h = self.fc(jnp.concatenate([f, z], axis=-1))
        h = fnn.relu(self.bn_sample(h, data_dict['part_valids'], train=train))
        out = self.head(h)
        rot = out[..., :4] + jnp.asarray([1.0, 0.0, 0.0, 0.0])
        rot = rot / jnp.linalg.norm(rot, axis=-1, keepdims=True)
        return {'rot': rot, 'trans': out[..., 4:]}


class TorchTiny(nn.Module):
    """`JaxTiny` in torch; `sample` takes the next of `self.noises`."""

    def __init__(self):
        super().__init__()
        self.enc = nn.Linear(3, H)
        self.bn_pre = MaskedBatchNorm(H)
        self.fc = nn.Linear(H + D, H)
        self.bn_sample = MaskedBatchNorm(H)
        self.head = nn.Linear(H, 7)
        self.noises = []

    def precompute(self, data_dict):
        valids = data_dict['part_valids']
        h = torch.relu(self.enc(data_dict['part_pcs']))
        h = self.bn_pre(h, valids[..., None])
        return {'f': h.amax(dim=2) * valids[..., None]}

    def sample(self, feats, data_dict, generator=None):
        del generator
        f = feats['f']
        h = self.fc(torch.cat([f, self.noises.pop(0)], dim=-1))
        h = torch.relu(self.bn_sample(h, data_dict['part_valids']))
        out = self.head(h)
        rot = out[..., :4] + out.new_tensor([1.0, 0.0, 0.0, 0.0])
        rot = rot / torch.linalg.norm(rot, dim=-1, keepdim=True)
        return {'rot': rot, 'trans': out[..., 4:]}


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731

    def dense(i, o):
        return {'kernel': 0.5 * f32(i, o), 'bias': 0.1 * f32(o)}

    def bn():
        return ({'scale': 1.0 + 0.1 * f32(H), 'bias': 0.1 * f32(H)},
                {'mean': 0.1 * f32(H),
                 'var': rng.uniform(0.5, 1.5, H).astype(np.float32)})

    (pre_p, pre_s), (smp_p, smp_s) = bn(), bn()
    params = {'enc': dense(3, H), 'bn_pre': pre_p, 'fc': dense(H + D, H),
              'bn_sample': smp_p, 'head': dense(H, 7)}
    return params, {'bn_pre': pre_s, 'bn_sample': smp_s}


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    valids = (np.arange(P)[None] <
              np.asarray([2, 4, 3])[:, None]).astype(np.float32)
    pcs = rng.uniform(-0.5, 0.5, (B, P, N, 3)).astype(np.float32)
    pcs *= valids[:, :, None, None]
    quat = rng.randn(B, P, 4).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return {'part_pcs': pcs, 'part_valids': valids,
            'part_trans': (0.3 * rng.randn(B, P, 3)).astype(np.float32),
            'part_quat': quat}


def _torch_tiny(params, stats):
    net = TorchTiny()
    sd = {}
    for name in ('enc', 'fc', 'head'):
        sd[f'{name}.weight'] = params[name]['kernel'].T
        sd[f'{name}.bias'] = params[name]['bias']
    for name in ('bn_pre', 'bn_sample'):
        sd[f'{name}.weight'] = params[name]['scale']
        sd[f'{name}.bias'] = params[name]['bias']
        sd[f'{name}.running_mean'] = stats[name]['mean']
        sd[f'{name}.running_var'] = stats[name]['var']
    net.load_state_dict({k: torch.tensor(np.ascontiguousarray(v))
                         for k, v in sd.items()}, strict=True)
    return net


def _cfg(pkg, sample_iter):
    opts = ['loss.sample_iter', str(sample_iter), 'loss.noise_dim', str(D)]
    return pkg.load_cfg_file(FLAGSHIP).merge_from_list(opts)


@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('sample_iter', [1, 3])
def test_mon_loss_bn_stats_match_jax(sample_iter, training):
    params, stats = _weights()
    batch = _batch()
    rng = jax.random.PRNGKey(7)

    model = JaxTiny()
    var = {'params': params, 'batch_stats': stats}
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    _, ref_logs, ref_stats = jax_mon_loss(
        model, params, stats, jdata, rng, cfg=_cfg(JCFG, sample_iter),
        training=training)
    # the noise each sample drew: mon_loss's key schedule (JAX
    # core.py:164, 173, 184), the first 'noise' draw of an apply
    keys = jax.random.split(jax.random.split(rng)[1], sample_iter)
    noises = [model.apply(var, (B, P, D), method=JaxTiny.noise,
                          rngs={'noise': jax.random.split(k, 3)[0]})
              for k in keys]

    net = _torch_tiny(params, stats)
    net.train(training)
    net.noises = [torch.tensor(np.asarray(z)) for z in noises]
    tdata = {k: torch.tensor(v) for k, v in batch.items()}
    _, logs = mon_loss(net, tdata, cfg=_cfg(TCFG, sample_iter),
                       training=training)

    assert not net.noises  # every sample drew its noise
    common = set(logs) & set(ref_logs)
    assert {'loss', 'trans_loss', 'rot_pt_cd_loss',
            'transform_pt_cd_loss'} <= common
    for k in sorted(common):
        np.testing.assert_allclose(float(logs[k].detach()),
                                   float(ref_logs[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)
    for name in ('bn_pre', 'bn_sample'):
        bn = getattr(net, name)
        for ours, theirs in ((bn.running_mean, 'mean'),
                             (bn.running_var, 'var')):
            np.testing.assert_allclose(
                ours.numpy(), np.asarray(ref_stats[name][theirs]), atol=TOL,
                rtol=TOL, err_msg=f'{name}.{theirs}')
    if not training:
        for name in ('bn_pre', 'bn_sample'):
            bn = getattr(net, name)
            assert np.array_equal(bn.running_mean.numpy(),
                                  stats[name]['mean'])
            assert np.array_equal(bn.running_var.numpy(),
                                  stats[name]['var'])


def test_one_sample_is_bitwise_one_precompute_and_sample():
    """sample_iter=1 on the flagship (narrowed): mon_loss's loss and every
    running statistic equal, bit for bit, those of one precompute and one
    sample, as before the statistics were snapshotted."""
    cfg = TCFG.load_cfg_file(FLAGSHIP).merge_from_list(
        ['model.pc_feat_dim', '16', 'model.transformer_feat_dim', '32',
         'model.transformer_heads', '4', 'model.transformer_layers', '2',
         'data.max_num_part', str(P), 'data.num_pc_points', str(N)])
    cfg.exp.bf16 = False
    assert cfg.loss.sample_iter == 1
    torch.manual_seed(0)
    net = build_model(cfg, 'cpu')
    for m in net.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    net.train()
    twin = copy.deepcopy(net)
    batch = _batch()
    data = {k: torch.tensor(v) for k, v in batch.items()}
    data['part_label'] = torch.zeros(B, P, 0)
    data['instance_label'] = torch.zeros(B, P, 0)

    loss, _ = mon_loss(net, data, cfg=cfg, training=True)

    plain = dict(data, part_rot_raw=data['part_quat'])
    feats = twin.precompute(plain)
    ld = loss_one_sample(
        twin.sample(feats, plain, None), plain, rot_type='quat',
        semantic=False, training=True, use_rot_loss=cfg.loss.use_rot_loss,
        use_rot_pt_l2_loss=cfg.loss.use_rot_pt_l2_loss, with_metrics=False)
    ref = sum(ld[k] * w for k, w in
              loss_weights_from_cfg(cfg.loss).items()).mean()
    assert torch.equal(loss.detach(), ref.detach())
    bufs = dict(twin.named_buffers())
    assert bufs and any('running' in k for k in bufs)
    for k, v in net.named_buffers():
        assert torch.equal(v, bufs[k]), k
