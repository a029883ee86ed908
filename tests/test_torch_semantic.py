"""The port's semantic (PartNet) assembly path against the JAX package:
the semantic loss (Hungarian matching, part and connectivity accuracy),
the MoN loss at the semantic recipe's sample_iter 5 with 32-d head noise,
each family's semantic build and weight conversion
(tests/test_torch_semantic_cli.py runs the CLIs).

The same numpy batch goes through both packages, JAX pinned to f32,
weights carried by convert.py, dropout off.  The random draws differ by
design, so the tests take JAX's and give them to the port: the head noise
of every sample (captured with flax's `intercept_methods` as the input of
the inner PoseRegressor, its last noise_dim columns, from an eager replay
of mon_loss's key schedule) through `StochasticPoseRegressor.
noise_override`, the match subsample of every supervised step
(`jax.random.permutation(key, N)[:100]`) through `mon_loss(match_idx=)`,
and LSTM's and RGL-Net's own draws as tests/test_torch_lstm.py and
test_torch_dgl.py do.

Tolerances (tests/torch_family_parity.py's): losses and logs atol 1e-5,
rtol 1e-4; forwards atol 1e-5, rtol 1e-4; gradients 1e-4 relative L2 per
parameter, plus for DGL and RGL-Net twice the JAX gradient's own movement
under 1e-7 and 1e-6 nudges of the clouds (batch norm over every row makes
their train-mode gradient ill-conditioned).
"""

import functools
import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_parity as U
from multi_part_assembly_tpu.models import build_model as jax_build_model
from multi_part_assembly_tpu.models.modules.regressor import \
    PoseRegressor as JaxPoseRegressor
from multi_part_assembly_tpu.train import core as JC
from multi_part_assembly_tpu.utils import config_utils as JCFG
from multi_part_assembly_tpu_torch.models import build_model, label_dim_of
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.models.modules.regressor import \
    StochasticPoseRegressor
from multi_part_assembly_tpu_torch.train import core as TC
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG

torch.set_num_threads(2)

sys.path.insert(0, os.path.join(U.ROOT, 'scripts'))
B, P, N, C = U.B, U.P, U.N, U.C
CONFIGS = U.SEMANTIC_CONFIGS
FAMILIES = sorted(CONFIGS)
NARROW = U.NARROW
LSTM_NOISE = 16


@pytest.fixture(scope='module', autouse=True)
def _f32_no_dropout():
    with U.jax_f32_no_dropout() as mp:
        # LSTM's decoder hidden noise [2, B, 16] and teacher-forcing flag
        # (tests/test_torch_lstm.py): fixed on both sides
        normal, hidden = jax.random.normal, _lstm_noise()
        mp.setattr(jax.random, 'normal',
                   lambda key, shape=(), dtype=jnp.float32:
                   jnp.asarray(hidden) if tuple(shape) == hidden.shape
                   else normal(key, shape, dtype))
        mp.setattr(jax.random, 'bernoulli',
                   lambda key, p=0.5, shape=None: jnp.asarray(True))
        yield


def _lstm_noise():
    return np.random.RandomState(5).randn(2, B, LSTM_NOISE).astype(
        np.float32)


def _rgl_hidden():
    return np.random.RandomState(4).randn(3, 1, 2, B, 2 * C).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def load_cfgs(family):
    """(JAX cfg, port cfg) of a family's partnet_chair config, narrowed
    (shared: read them, never modify them)."""
    opts = NARROW[family] + ['data.max_num_part', str(P),
                             'data.num_pc_points', str(N)]
    path = os.path.join(U.ROOT, CONFIGS[family])
    jcfg = JCFG.load_cfg_file(path).merge_from_list(opts)
    tcfg = TCFG.load_cfg_file(path).merge_from_list(opts)
    tcfg.exp.bf16 = False
    if family == 'pn_transformer_refine':
        jcfg.model.transformer_pos_enc = tcfg.model.transformer_pos_enc = \
            (C, C)
    return jcfg, tcfg


def sem_batch(seed=0, counts=U.COUNTS):
    """A semantic numpy batch: U.batch's clouds and poses, geometry classes
    with repeats, the dataset's instance_label, match_ids and part_ids, and
    chained contact points (flag first)."""
    b = U.batch(seed, counts)
    rng = np.random.RandomState(seed + 100)
    nb = len(counts)
    geo = np.zeros((nb, P), np.float32)
    inst = np.zeros((nb, P, P), np.float32)
    match = np.zeros((nb, P), np.float32)
    contacts = np.zeros((nb, P, P, 4), np.float32)
    for i, n in enumerate(counts):
        g = rng.randint(1, max(2, n // 2 + 1) + 1, n)
        g[:2] = 1  # at least one group of two
        geo[i, :n] = g
        seen = {}
        for j in range(n):
            inst[i, j, seen.get(g[j], 0)] = 1
            seen[g[j]] = seen.get(g[j], 0) + 1
        group = 1
        for cls in range(1, int(g.max()) + 1):
            idx = np.where(g == cls)[0]
            if len(idx) > 1:
                match[i, idx] = group
                group += 1
        for j in range(n - 1):
            p = rng.uniform(-0.1, 0.1, 3)
            contacts[i, j, j + 1] = [1, *p]
            contacts[i, j + 1, j] = [1, *(p + 0.001)]
    b.update(part_ids=geo, instance_label=inst, match_ids=match,
             contact_points=contacts)
    return b


def jax_draws(model, var, data, cfg, training):
    """JAX mon_loss's draws (core.py:164-185) under the key
    U.jax_mon_step gives it, replayed eagerly: the head noise of every pose
    head of every sample, [sample][head call], and the match subsample of
    every supervised step, sample by sample."""
    rng = jax.random.PRNGKey(3)
    noise_dim = cfg.loss.noise_dim
    jdata = U.to_jax(data)
    stats = var.get('batch_stats', {})
    pre_key, key = jax.random.split(rng)
    feats, mut = model.apply(var, jdata, train=training, method='precompute',
                             mutable=['batch_stats'],
                             rngs={'dropout': pre_key})
    var_s = {'params': var['params'],
             'batch_stats': mut.get('batch_stats', stats)}
    noises, idx = [], []
    for k in jax.random.split(key, cfg.loss.sample_iter):
        nkey, dkey, mkey = jax.random.split(k, 3)
        seen = []

        def capture(fn, args, kwargs, ctx):
            if isinstance(ctx.module, JaxPoseRegressor) and \
                    ctx.method_name == '__call__' and noise_dim > 0:
                seen.append(np.asarray(args[0][..., -noise_dim:]))
            return fn(*args, **kwargs)
        with fnn.intercept_methods(capture):
            pred, _ = model.apply(var_s, feats, jdata, train=training,
                                  method='sample', mutable=['batch_stats'],
                                  rngs={'noise': nkey, 'dropout': dkey})
        noises.append(seen)
        keys = jax.random.split(mkey, pred['trans'].shape[0]) \
            if pred['trans'].ndim == 4 else [mkey]
        idx += [np.asarray(jax.random.permutation(kk, N)[:100])
                for kk in keys]
    return noises, idx


def inject_noise(net, noises):
    """Give each of the port's stochastic heads its JAX noise, sample by
    sample (the heads run in registration order)."""
    heads = [m for m in net.modules()
             if isinstance(m, StochasticPoseRegressor) and m.noise_dim > 0]
    for h in heads:
        h.noise_override = []
    for per_sample in noises:
        assert len(per_sample) == len(heads)
        for h, z in zip(heads, per_sample):
            h.noise_override.append(torch.tensor(z))
    return heads


@functools.lru_cache(maxsize=None)
def _variables(family):
    jcfg, _ = load_cfgs(family)
    model = jax_build_model(jcfg)
    if family == 'rgl_net':
        model = model.clone(hidden_noise_override=jnp.asarray(_rgl_hidden()))
    return model, U.jax_init(model, U.to_jax(sem_batch()), train=False)


def _port(family, var):
    _, tcfg = load_cfgs(family)
    net = U.torch_no_dropout(build_model(tcfg, 'cpu'))
    net.load_state_dict(jax_to_state_dict(var, family), strict=True)
    if family == 'rgl_net':
        net.hidden_noise_override = torch.tensor(_rgl_hidden())
    if family == 'lstm':
        net.hidden_noise_override = torch.tensor(_lstm_noise())
        net.teacher_force_override = True
    return net, tcfg


def _step(family, data, training):
    """(JAX mon_loss outputs, the port's, the port's heads) on `data` with
    JAX's draws given to the port."""
    model, var = _variables(family)
    jcfg, _ = load_cfgs(family)
    net, tcfg = _port(family, var)
    noises, idx = jax_draws(model, var, data, jcfg, training)
    ref = U.jax_mon_step(model, var, data, jcfg, training=training)
    heads = inject_noise(net, noises)
    ours = U.torch_mon_step(net, data, tcfg, training=training,
                            match_idx=idx)
    assert all(h.noise_override == [] for h in heads)
    return ref, ours, (model, var, net)


# ---------------------------------------------------------------------------
# build_model and convert.py on the semantic configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('family', FAMILIES)
def test_semantic_build_at_published_width(family):
    """Each partnet_chair config builds at its published width: the first
    head layer reads the labels (instance_label, max_num_part = 20 wide;
    part_label is not in any shipped config's data_keys) and the 32-d
    noise, and DGL / RGL-Net merge equivalent parts."""
    cfg = TCFG.load_cfg_file(os.path.join(U.ROOT, CONFIGS[family]))
    assert cfg.data.dataset == 'partnet' and label_dim_of(cfg) == 20
    assert cfg.loss.sample_iter == 5 and cfg.loss.noise_dim == 32
    net = build_model(cfg, 'cpu')
    sd = net.state_dict()
    F_ = cfg.model.get('pc_feat_dim', 0)
    head_in = {
        'pn_transformer': ('head.fc_layers.0.weight', F_ + 20 + 32),
        'pn_transformer_refine': ('head.2.fc_layers.0.weight',
                                  2 * F_ + 20 + 7 + 32),
        'global': ('head.fc_layers.0.weight', 2 * F_ + 20 + 32),
        'lstm': ('head.fc_layers.0.weight', F_ + 20 + 32),
        'dgl': ('pose_predictors.2.fc_layers.0.weight', F_ + 20 + 7 + 32),
        'rgl_net': ('pose_predictors.2.fc_layers.0.weight',
                    F_ + 20 + 7 + 32),
        'identity': (None, None),
    }[family]
    if head_in[0] is not None:
        assert tuple(sd[head_in[0]].shape) == (256, head_in[1])
    if family in ('dgl', 'rgl_net'):
        assert net.semantic and net.merge_node
    geo = TCFG.load_cfg_file(os.path.join(
        U.ROOT, U.CONFIGS.get(family, 'configs/pn_transformer/'
                              'pn_transformer/pn_transformer-32x1-'
                              'cosine_400e-everyday.py')))
    assert label_dim_of(geo) == 0


def test_label_dim_counts_part_label():
    cfg = TCFG.load_cfg_file(os.path.join(U.ROOT, CONFIGS['pn_transformer']))
    cfg.data.data_keys = ('part_label', ) + tuple(cfg.data.data_keys)
    assert label_dim_of(cfg) == 20 + cfg.data.num_part_category
    net = build_model(cfg, 'cpu')
    assert net.head.fc_layers[0].weight.shape[1] == \
        cfg.model.pc_feat_dim + 20 + 57 + 32


@pytest.mark.parametrize('family', FAMILIES)
def test_semantic_convert_covers_every_tensor(family):
    _, var = _variables(family)
    _, tcfg = load_cfgs(family)
    sd = jax_to_state_dict(var, family)
    ours = build_model(tcfg, 'cpu').state_dict()
    assert set(sd) == set(ours)
    for k, v in ours.items():
        assert sd[k].shape == v.shape, k


# ---------------------------------------------------------------------------
# the semantic loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('rot_type', ['quat', 'rmat'])
def test_semantic_calc_loss_matches_jax(rot_type, training):
    """calc_loss(semantic=True) on a raw prediction, JAX's subsample
    injected: the same key set (at eval part_acc and connectivity_acc, no
    translation or rotation errors), every value within 1e-5."""
    from multi_part_assembly_tpu.utils.rotation import Rotation3D as JRot
    d = sem_batch(4)
    rng = np.random.RandomState(8)
    pred_t = (d['part_trans'] + 0.05 * rng.randn(B, P, 3)).astype(
        np.float32)
    if rot_type == 'quat':
        pred = (d['part_quat'] + 0.2 * rng.randn(B, P, 4)).astype(np.float32)
    else:
        pred = rng.randn(B, P, 6).astype(np.float32)
    gt_raw = np.asarray(JRot(jnp.asarray(d['part_quat']), 'quat').convert(
        rot_type).rot)
    data = dict(d, part_rot_raw=gt_raw)
    kw = dict(rot_type=rot_type, semantic=True, training=training,
              use_rot_loss=False, use_rot_pt_l2_loss=True,
              with_metrics=not training)
    key = jax.random.PRNGKey(13)
    ref = JC.calc_loss(jnp.asarray(pred), jnp.asarray(pred_t), U.to_jax(data),
                       match_key=key, **kw)
    idx = torch.tensor(np.asarray(jax.random.permutation(key, N)[:100]))
    ours = TC.calc_loss(torch.tensor(pred), torch.tensor(pred_t),
                        U.to_torch(data), match_idx=iter([idx]), **kw)
    assert set(ours) == set(ref)
    metrics = {'part_acc', 'connectivity_acc'}
    assert (metrics <= set(ours)) == (not training)
    assert not any(k.startswith(('trans_m', 'trans_r', 'rot_m', 'rot_r'))
                   for k in ours)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def test_mon_loss_at_sample_iter_5_matches_jax():
    """PN-Transformer's semantic recipe: 5 samples of 32-d noise, each
    matched on its own subsample; the per-element argmin picks among
    samples that differ.  Loss and logs within 1e-5, every gradient 1e-4
    relative L2, the running statistics within 1e-5."""
    _, tcfg = load_cfgs('pn_transformer')
    assert tcfg.loss.sample_iter == 5 and tcfg.loss.noise_dim == 32
    data = sem_batch(2)
    ref, ours, (model, var, net) = _step('pn_transformer', data, True)
    U.assert_train_step_matches(ours, ref, var, 'pn_transformer')
    # the samples differ: their losses spread
    noises, idx = jax_draws(model, var, data, load_cfgs('pn_transformer')[0],
                            True)
    assert len(noises) == 5 and len(idx) == 5
    inject_noise(net, noises)
    net.train()
    kw = dict(rot_type='quat', semantic=True, training=True,
              use_rot_loss=False, use_rot_pt_l2_loss=False)
    td = U.to_torch(data)
    td['part_rot_raw'] = td['part_quat']
    feats = net.precompute(td)
    losses = [TC.loss_one_sample(net.sample(feats, td), td,
                                 match_idx=iter([torch.tensor(i)]),
                                 **kw)['trans_loss'].detach() for i in idx]
    assert float(torch.stack(losses).std(0).min()) > 1e-6


def test_mon_loss_draws_noise_then_subsamples_from_the_generator():
    """Without overrides, one generator seed gives one loss; another seed
    another (noise and subsample both come from the generator)."""
    _, var = _variables('pn_transformer')
    net, tcfg = _port('pn_transformer', var)
    data = U.to_torch(sem_batch(3))
    net.eval()
    with torch.no_grad():
        losses = [TC.mon_loss(net, data, cfg=tcfg, training=False,
                              generator=torch.Generator().manual_seed(s))[0]
                  for s in (0, 0, 1)]
    assert torch.equal(losses[0], losses[1])
    assert not torch.equal(losses[0], losses[2])


# ---------------------------------------------------------------------------
# every family's semantic build against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('family', FAMILIES)
def test_semantic_eval_forward_and_logs_match_jax(family):
    """The eval forward with JAX's noise, and the eval MoN logs (losses,
    part_acc, connectivity_acc) with JAX's draws."""
    model, var = _variables(family)
    jcfg, _ = load_cfgs(family)
    b = sem_batch(1)
    key = jax.random.PRNGKey(21)
    seen = []

    def capture(fn, args, kwargs, ctx):
        if isinstance(ctx.module, JaxPoseRegressor) and \
                ctx.method_name == '__call__':
            seen.append(np.asarray(args[0][..., -jcfg.loss.noise_dim:]))
        return fn(*args, **kwargs)
    with fnn.intercept_methods(capture):
        ref = model.apply(var, U.to_jax(b), train=False,
                          rngs={'noise': key})
    net, tcfg = _port(family, var)
    if family != 'identity':
        inject_noise(net, [seen])
    with torch.no_grad():
        out = net.eval()(U.to_torch(b))
    for k in ('rot', 'trans'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=1e-4)
    ref_logs, ours, _ = _step(family, b, False)
    assert {'part_acc', 'connectivity_acc'} <= set(ours)
    U.assert_eval_logs_match(ours, ref_logs)


@pytest.mark.parametrize('family', FAMILIES)
def test_semantic_train_mon_loss_and_gradients_match_jax(family):
    """One train-mode MoN loss at sample_iter 5 (multi-step families: each
    supervised step matched on its own subsample and logged as `{k}_{i}`),
    every gradient and the BN running statistics."""
    b = sem_batch(2)
    ref, ours, (model, var, _) = _step(family, b, True)
    tol = 1e-4
    if family in ('dgl', 'rgl_net'):
        assert 'trans_loss_2' in ref['logs']
        resolution = U.jax_gradient_resolution(model, var, b,
                                               load_cfgs(family)[0])
        assert resolution < 1e-2
        tol += 2 * resolution
    if family == 'identity':
        assert not any(g.any() for g in ours['grads'].values())
    U.assert_train_step_matches(ours, ref, var, family, grad_tol=tol)
