"""The 6D PN-Transformer (`model.rot_type rmat`) against the JAX package:
the flagship config at a small width, weights converted from JAX, the same
augmented batch, dropout off and f32 on both sides.

Compared: the forward's 6D rotations and translations (atol 1e-5), the
train `mon_loss` and its parts (atol 1e-5, rtol 1e-4), every parameter
gradient (relative L2 1e-3 a tensor, and atol 2e-4, rtol 1e-3 an element:
the Gram-Schmidt backward carries f32 rounding in another order, up to
2.5e-4 relative on the rotation head), and the eval `mon_loss` with the full
metric set (the same keys; atol 1e-5, rtol 1e-4, the Euler metrics atol
1e-3 degrees), as
tests/test_torch_train_step.py does for quaternions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import (FLAGSHIP, OPTS, B, P, _raw_batch,
                                   no_dropout_f32)  # noqa: F401

from multi_part_assembly_tpu.datasets.geometry import \
    augment_geometry_batch as jax_augment
from multi_part_assembly_tpu.models import build_model as jax_build_model
from multi_part_assembly_tpu.train.core import mon_loss as jax_mon_loss
from multi_part_assembly_tpu.utils import config_utils as JCFG
from multi_part_assembly_tpu_torch.datasets import augment_geometry_batch
from multi_part_assembly_tpu_torch.models import build_model
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.train.core import mon_loss
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG
from multi_part_assembly_tpu_torch.utils.rotation import quaternion_invert

torch.set_num_threads(2)

OPTS_6D = OPTS + ['model.rot_type', 'rmat']
EULER = {'rot_mse', 'rot_rmse', 'rot_mae'}


def _jax_side(raw, valids):
    cfg = JCFG.load_cfg_file(FLAGSHIP).merge_from_list(OPTS_6D)
    model = jax_build_model(cfg)
    aug = jax_augment(jnp.asarray(raw), jnp.asarray(valids),
                      jax.random.PRNGKey(5))
    data = {**aug, 'part_valids': jnp.asarray(valids),
            'part_label': jnp.zeros((B, P, 0)),
            'instance_label': jnp.zeros((B, P, 0))}
    var = jax.jit(lambda r, d: model.init(r, d, train=True))(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1),
         'noise': jax.random.PRNGKey(2)}, data)
    params, stats = var['params'], var['batch_stats']
    out = model.apply(var, data, train=False,
                      rngs={'noise': jax.random.PRNGKey(3)})

    def loss_fn(p, training):
        loss, logs, _ = jax_mon_loss(
            model, p, stats, data, jax.random.PRNGKey(3), cfg=cfg,
            training=training)
        return loss, logs

    (_, logs), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, True), has_aux=True))(params)
    _, eval_logs = jax.jit(lambda p: loss_fn(p, False))(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(aug=to_np(aug), out=to_np(out), logs=to_np(logs),
                eval_logs=to_np(eval_logs), grads=to_np(grads),
                var=to_np({'params': params, 'batch_stats': stats}))


@pytest.fixture(scope='module')
def sides(no_dropout_f32):  # noqa: F811
    raw, valids = _raw_batch()
    ref = _jax_side(raw, valids)
    cfg = TCFG.load_cfg_file(FLAGSHIP).merge_from_list(OPTS_6D)
    cfg.exp.bf16 = False
    net = build_model(cfg, 'cpu')
    sd = jax_to_state_dict(ref['var'])
    assert sd['head.rot_head.weight'].shape == (6, 128)
    net.load_state_dict(sd, strict=True)
    for m in net.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    valids_t = torch.tensor(valids)
    quat = quaternion_invert(torch.tensor(ref['aug']['part_quat']))
    aug = augment_geometry_batch(torch.tensor(raw), valids_t, quat=quat)
    data = {**aug, 'part_valids': valids_t,
            'part_label': torch.zeros(B, P, 0),
            'instance_label': torch.zeros(B, P, 0)}
    net.eval()
    with torch.no_grad():
        out = net(data)
        _, eval_logs = mon_loss(net, data, cfg=cfg, training=False)
    net.train()
    _, logs = mon_loss(net, data, cfg=cfg, training=True)
    logs['loss'].backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    return ref, dict(out=out, logs=logs, eval_logs=eval_logs, grads=grads)


def test_forward_matches_jax(sides):
    ref, ours = sides
    assert ours['out']['rot'].shape == (B, P, 6)
    for k in ('rot', 'trans'):
        np.testing.assert_allclose(ours['out'][k].numpy(), ref['out'][k],
                                   atol=1e-5, rtol=0, err_msg=k)


def test_train_mon_loss_matches_jax(sides):
    ref, ours = sides
    assert set(ours['logs']) == set(ref['logs'])
    assert 'rot_loss' in ref['logs']  # the rmat cosine loss
    for k, v in ref['logs'].items():
        np.testing.assert_allclose(float(ours['logs'][k].detach()), v,
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def test_gradients_match_jax(sides):
    ref, ours = sides
    ref_grads = jax_to_state_dict({'params': ref['grads'],
                                   'batch_stats': ref['var']['batch_stats']})
    for name, g in ours['grads'].items():
        r = ref_grads[name].numpy()
        rel = np.linalg.norm(g.numpy() - r) / max(np.linalg.norm(r), 1e-12)
        assert rel <= 1e-3, (name, rel)
        np.testing.assert_allclose(g.numpy(), r, atol=2e-4, rtol=1e-3,
                                   err_msg=name)


def test_eval_metrics_match_jax(sides):
    ref, ours = sides
    assert set(ours['eval_logs']) == set(ref['eval_logs'])
    assert EULER | {'part_acc', 'trans_rmse'} <= set(ref['eval_logs'])
    for k, v in ref['eval_logs'].items():
        atol, rtol = (1e-3, 0) if k in EULER else (1e-5, 1e-4)
        if k == 'rot_mse':
            atol *= max(1.0, abs(float(v)))
        np.testing.assert_allclose(float(ours['eval_logs'][k]), v,
                                   atol=atol, rtol=rtol, err_msg=k)
