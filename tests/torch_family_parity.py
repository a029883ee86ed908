"""Shared helpers of the geometric families' parity tests
(tests/test_torch_rnn.py, test_torch_lstm.py, test_torch_dgl.py,
test_torch_families.py): the same numpy inputs from a seed through the JAX
module and its port, JAX pinned to f32, weights carried by convert.py,
dropout off on both sides.

Tolerances: forwards atol 1e-5, rtol 1e-4; gradients 1e-4 relative L2
per parameter.
"""

import contextlib
import functools
import os

import flax.linen as fnn
import flax.linen.attention as fattn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from multi_part_assembly_tpu.train.core import mon_loss as jax_mon_loss
from multi_part_assembly_tpu.utils import config_utils as JCFG
from multi_part_assembly_tpu.utils import precision
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.train.core import mon_loss
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'forward_values.npz')
B, P, N, C = 3, 6, 32, 16
COUNTS = (2, 6, 4)
CONFIGS = {
    'global': 'configs/global/global-32x1-cosine_200e-everyday.py',
    'lstm': 'configs/lstm/lstm-32x1-cosine_200e-everyday.py',
    'dgl': 'configs/dgl/dgl-32x1-cosine_200e-everyday.py',
    'rgl_net': 'configs/rgl_net/rgl_net-32x1-cosine_200e-everyday.py',
    'pn_transformer_refine': 'configs/pn_transformer/pn_transformer_refine/'
                             'pn_transformer_refine-32x1-cosine_400e-'
                             'everyday.py',
    'identity': 'configs/identity/identity-32x1-cosine_200e-everyday.py',
}
# the partnet_chair configs, one a family
SEMANTIC_CONFIGS = {
    'pn_transformer': 'configs/pn_transformer/pn_transformer/'
                      'pn_transformer-32x1-cosine_400e-partnet_chair.py',
    'pn_transformer_refine': 'configs/pn_transformer/pn_transformer_refine/'
                             'pn_transformer_refine-32x1-cosine_400e-'
                             'partnet_chair.py',
    'global': 'configs/global/global-32x1-cosine_200e-partnet_chair.py',
    'lstm': 'configs/lstm/lstm-32x1-cosine_200e-partnet_chair.py',
    'dgl': 'configs/dgl/dgl-32x1-cosine_300e-partnet_chair.py',
    'rgl_net': 'configs/rgl_net/rgl_net-32x1-cosine_300e-partnet_chair.py',
    'identity': 'configs/identity/identity-32x1-cosine_200e-'
                'partnet_chair.py',
}
# the everyday configs at a small size
NARROW = {
    'global': ['model.pc_feat_dim', str(C)],
    'lstm': ['model.pc_feat_dim', str(C), 'model.lstm_hidden_size', '20'],
    'dgl': ['model.pc_feat_dim', str(C)],
    'rgl_net': ['model.pc_feat_dim', str(C)],
    'pn_transformer_refine': [
        'model.pc_feat_dim', str(C), 'model.transformer_feat_dim', '32',
        'model.transformer_heads', '4', 'model.refine_steps', '2'],
    'identity': [],
    'pn_transformer': [
        'model.pc_feat_dim', str(C), 'model.transformer_feat_dim', '32',
        'model.transformer_heads', '4', 'model.transformer_layers', '2'],
}


@functools.lru_cache(maxsize=None)
def load_cfgs(family):
    """(JAX cfg, port cfg) of a family's everyday config, narrowed (shared:
    read them, never modify them)."""
    opts = NARROW[family] + ['data.max_num_part', str(P),
                             'data.num_pc_points', str(N)]
    path = os.path.join(ROOT, CONFIGS[family])
    jcfg = JCFG.load_cfg_file(path).merge_from_list(opts)
    tcfg = TCFG.load_cfg_file(path).merge_from_list(opts)
    tcfg.exp.bf16 = False
    if family == 'pn_transformer_refine':
        jcfg.model.transformer_pos_enc = tcfg.model.transformer_pos_enc = \
            (C, C)
    return jcfg, tcfg


@contextlib.contextmanager
def jax_f32_no_dropout():
    """f32 compute and no dropout in the JAX model (flax Dropout and the
    attention-weight dropout; positional argument 6 is dropout_rate)."""
    import pytest
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, '__call__', lambda self, x, *a, **kw: x)
        weights = fattn.dot_product_attention_weights
        mp.setattr(fattn, 'dot_product_attention_weights',
                   lambda *a, **kw: weights(*a[:6], 0.0, *a[7:], **kw))
        prev = precision.compute_dtype()
        precision.set_compute_dtype(jnp.float32)
        try:
            yield mp
        finally:
            precision.set_compute_dtype(prev)


def torch_no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def batch(seed=0, counts=COUNTS):
    """A numpy batch: clouds, valids, random unit quaternions and
    translations, empty labels, part_ids and valid_matrix."""
    rng = np.random.RandomState(seed)
    b = len(counts)
    valids = (np.arange(P)[None] <
              np.asarray(counts)[:, None]).astype(np.float32)
    centres = rng.uniform(-0.4, 0.4, (b, P, 1, 3))
    pcs = (centres + 0.1 * rng.randn(b, P, N, 3)).astype(np.float32)
    quat = rng.randn(b, P, 4)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return {
        'part_pcs': pcs * valids[:, :, None, None],
        'part_valids': valids,
        'part_quat': (quat * valids[..., None]).astype(np.float32),
        'part_trans': (0.3 * rng.randn(b, P, 3) *
                       valids[..., None]).astype(np.float32),
        'part_label': np.zeros((b, P, 0), np.float32),
        'instance_label': np.zeros((b, P, 0), np.float32),
        'part_ids': np.where(valids > 0, np.arange(P)[None], 0).astype(
            np.float32),
        'valid_matrix': valids[:, :, None] * valids[:, None, :],
    }


def to_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def to_torch(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def randomize_stats(var, seed):
    """Non-trivial BN running statistics in every `batch_stats` leaf."""
    rng = np.random.RandomState(seed)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k == 'mean':
                tree[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif k == 'var':
                tree[k] = (1 + 0.2 * rng.rand(*v.shape)).astype(np.float32)
    fill(var.get('batch_stats', {}))
    return var


def jax_init(model, data, seed=0, method=None, **kw):
    """JAX-initialised variables as numpy, with non-trivial BN running
    statistics."""
    var = model.init({'params': jax.random.PRNGKey(seed),
                      'dropout': jax.random.PRNGKey(1),
                      'noise': jax.random.PRNGKey(2)}, data, method=method,
                     **kw)
    var = _unfreeze(jax.tree_util.tree_map(np.asarray, var))
    return randomize_stats(var, seed + 7)


def _unfreeze(tree):
    if hasattr(tree, 'items'):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return tree


_JITTED = {}


def _jax_step_fn(model, cfg, training):
    """The jitted JAX mon_loss (with its gradient in training), one a
    (model, cfg, mode) and a set of JAX draws (tests replace the random
    functions, which a trace bakes in): later batches of the same shapes
    reuse it."""
    key = (id(model), id(cfg), training, jax.random.normal,
           jax.random.bernoulli)
    if key not in _JITTED:
        def loss_fn(p, stats, jdata):
            loss, logs, new_stats = jax_mon_loss(
                model, p, stats, jdata, jax.random.PRNGKey(3), cfg=cfg,
                training=training, reduce=training)
            return loss, (logs, new_stats)
        fn = jax.value_and_grad(loss_fn, has_aux=True) if training \
            else loss_fn
        _JITTED[key] = (model, cfg, jax.jit(fn))
    return _JITTED[key][2]


def jax_mon_step(model, var, data, cfg, training=True):
    """JAX mon_loss, and in training its gradients and new BN statistics,
    as numpy."""
    params = var['params']
    stats = var.get('batch_stats', {})
    fn = _jax_step_fn(model, cfg, training)
    if not training:
        _, (logs, _) = fn(params, stats, to_jax(data))
        return jax.tree_util.tree_map(np.asarray, logs)
    (loss, (logs, new_stats)), grads = fn(params, stats, to_jax(data))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(loss=float(loss), logs=to_np(logs), grads=to_np(grads),
                new_stats=to_np(new_stats))


def torch_mon_step(net, data, cfg, training=True, match_idx=None):
    """The port's mon_loss on the same batch (semantic data: the match
    subsamples `match_idx`, as tensors); in training its gradients (None as
    zeros) and the module's state after the step."""
    tdata = to_torch(data)
    kw = {} if match_idx is None else \
        {'match_idx': [torch.tensor(np.asarray(i)) for i in match_idx]}
    if not training:
        net.eval()
        with torch.no_grad():
            _, logs = mon_loss(net, tdata, cfg=cfg, training=False,
                               reduce=False, **kw)
        return {k: v.numpy() for k, v in logs.items()}
    net.train()
    net.zero_grad(set_to_none=True)
    loss, logs = mon_loss(net, tdata, cfg=cfg, training=True, **kw)
    if loss.requires_grad:
        loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in net.named_parameters()}
    return dict(loss=float(loss.detach()), grads=grads,
                logs={k: float(v.detach()) for k, v in logs.items()},
                state=net.state_dict())


def rel_l2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(grads):
    return np.concatenate([np.asarray(g).ravel() for g in grads])


def jax_gradient_resolution(model, var, data, cfg):
    """How far the JAX train-mode gradient itself moves when the clouds move
    by a relative 1e-7 (about one f32 ulp) or 1e-6, in fixed random
    directions: the largest relative L2 change.  Where batch norm runs over
    every row with its batch statistics (DGL's and RGL-Net's edge and node
    MLPs), the gradient is ill-conditioned at this size, and two correct f32
    implementations differ by about this much."""
    base = _flat(jax.tree_util.tree_leaves(
        jax_mon_step(model, var, data, cfg)['grads']))
    worst = 0.0
    for eps in (1e-7, 1e-6):
        nudged = dict(data)
        d = np.random.RandomState(99).randn(*data['part_pcs'].shape)
        nudged['part_pcs'] = (data['part_pcs'] * (1 + eps * d)).astype(
            np.float32)
        g = _flat(jax.tree_util.tree_leaves(
            jax_mon_step(model, var, nudged, cfg)['grads']))
        worst = max(worst, rel_l2(g, base))
    return worst


def assert_gradients_match(grads, ref_grads, tol):
    """Every parameter's gradient within `tol` relative L2 of the
    reference's, with a floor of 1e-6 of the whole gradient's norm: a
    parameter whose true gradient is zero (a bias in front of a batch norm)
    carries float noise only."""
    floor = 1e-6 * np.linalg.norm(_flat(
        [ref_grads[n].numpy() for n in grads]))
    assert set(ref_grads) >= set(grads)
    for name, g in grads.items():
        g, r = g.numpy(), ref_grads[name].numpy()
        err = float(np.linalg.norm(g - r))
        assert err <= tol * float(np.linalg.norm(r)) + floor, \
            f'{name}: gradient rel. L2 {rel_l2(g, r):.2e} (limit {tol:.2e})'


def assert_train_step_matches(ours, ref, var, family, grad_tol=1e-4):
    """Loss and logs (atol 1e-5, rtol 1e-4), every gradient (`grad_tol`
    relative L2) and every BN running statistic (atol 1e-5, rtol 1e-4)."""
    np.testing.assert_allclose(ours['loss'], ref['loss'], atol=1e-5,
                               rtol=1e-4)
    assert set(ours['logs']) == set(ref['logs'])
    for k, v in ref['logs'].items():
        np.testing.assert_allclose(ours['logs'][k], v, atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    ref_grads = jax_to_state_dict({'params': ref['grads'],
                                   'batch_stats': var.get('batch_stats', {})},
                                  family)
    assert_gradients_match(ours['grads'], ref_grads, grad_tol)
    after = jax_to_state_dict({'params': var['params'],
                               'batch_stats': ref['new_stats']}, family)
    for name, v in ours['state'].items():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(v.numpy(), after[name].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=name)


def eval_gradients(model, var, net, data, jcfg, tcfg, family):
    """The gradients of the eval-mode MoN loss (batch norms on their running
    statistics) on both sides: (port, JAX as a port state_dict)."""
    stats = var.get('batch_stats', {})
    g = jax.grad(lambda p: jax_mon_loss(
        model, p, stats, to_jax(data), jax.random.PRNGKey(3), cfg=jcfg,
        training=False)[0])(var['params'])
    ref = jax_to_state_dict({'params': jax.tree_util.tree_map(np.asarray, g),
                             'batch_stats': stats}, family)
    net.eval()
    net.zero_grad(set_to_none=True)
    mon_loss(net, to_torch(data), cfg=tcfg, training=False)[0].backward()
    ours = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
            for n, p in net.named_parameters()}
    return ours, ref


def assert_eval_logs_match(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def golden():
    """The torch-reference forward goldens, the DGL weights stored as f16
    upcast (as tests/test_golden_forward.py reads them)."""
    return {k: v.astype(np.float32) if v.dtype == np.float16 else v
            for k, v in np.load(GOLDEN).items()}
