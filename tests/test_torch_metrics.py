"""The port's eval metrics and the losses of the 6D path against the JAX
package, on the same numpy inputs.

Tolerances: the translation metrics, rot_l2_loss, rot_cosine_loss and the
losses of calc_loss atol 1e-5 (f32 in another order); the Euler metrics
atol 1e-3 degrees (an arcsin and two atan2 of f32 inputs, scaled by
180 / pi); the connectivity accuracy exactly (a count over the batch).
The JAX chamfer runs its jnp fallback on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_part_assembly_tpu.train import core as JC
from multi_part_assembly_tpu.utils import eval_utils as JE
from multi_part_assembly_tpu.utils import loss as JL
from multi_part_assembly_tpu.utils.rotation import Rotation3D as JRot
from multi_part_assembly_tpu_torch.train import core as TC
from multi_part_assembly_tpu_torch.utils import eval_utils as TE
from multi_part_assembly_tpu_torch.utils import loss as TL
from multi_part_assembly_tpu_torch.utils.rotation import Rotation3D as TRot

torch.set_num_threads(2)

METRICS = ('mse', 'rmse', 'mae')
EVAL_KEYS = {'part_acc'} | {f'{k}_{m}' for k in ('trans', 'rot')
                            for m in METRICS}


def _unit(q):
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.RandomState(0)
    B, P, N = 3, 6, 32
    valids = (np.arange(P)[None] <
              np.asarray([2, 6, 4])[:, None]).astype(np.float32)
    q1 = _unit(rng.randn(B, P, 4))
    q2 = _unit(q1 + 0.3 * rng.randn(B, P, 4))
    t1 = (0.2 * rng.randn(B, P, 3)).astype(np.float32)
    t2 = (t1 + 0.02 * rng.randn(B, P, 3)).astype(np.float32)
    pts = (0.1 * rng.randn(B, P, N, 3)).astype(np.float32)
    d6 = rng.randn(B, P, 6).astype(np.float32)
    return dict(q1=q1, q2=q2, t1=t1, t2=t2, pts=pts, valids=valids, d6=d6)


def _rots(d, rot_type):
    """(JAX, port) Rotation3D pairs of q1 and q2 as `rot_type`."""
    return [(JRot(jnp.asarray(d[k]), 'quat').convert(rot_type),
             TRot(torch.tensor(d[k]), 'quat').convert(rot_type))
            for k in ('q1', 'q2')]


@pytest.mark.parametrize('metric', METRICS)
def test_trans_metrics(inputs, metric):
    d = inputs
    ref = JE.trans_metrics(jnp.asarray(d['t1']), jnp.asarray(d['t2']),
                           jnp.asarray(d['valids']), metric)
    ours = TE.trans_metrics(torch.tensor(d['t1']), torch.tensor(d['t2']),
                            torch.tensor(d['valids']), metric)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize('rot_type', ['quat', 'rmat'])
@pytest.mark.parametrize('metric', METRICS)
def test_rot_metrics(inputs, metric, rot_type):
    (j1, t1), (j2, t2) = _rots(inputs, rot_type)
    v = inputs['valids']
    ref = np.asarray(JE.rot_metrics(j1, j2, jnp.asarray(v), metric))
    ours = TE.rot_metrics(t1, t2, torch.tensor(v), metric).numpy()
    scale = max(1.0, float(np.abs(ref).max())) if metric == 'mse' else 1.0
    np.testing.assert_allclose(ours, ref, atol=1e-3 * scale, rtol=0)
    assert (ref > 0).all()


@pytest.mark.parametrize('rot_type', ['quat', 'rmat'])
def test_connectivity_acc(rot_type):
    """Contacts built from GT poses; the predicted poses move some parts,
    so the accuracy is strictly between 0 and 1, and exactly JAX's."""
    rng = np.random.RandomState(1)
    B, P = 3, 5
    q = _unit(rng.randn(B, P, 4))
    t = (0.3 * rng.randn(B, P, 3)).astype(np.float32)
    rmat = np.asarray(JRot(jnp.asarray(q), 'quat').to_rmat())
    cp = np.zeros((B, P, P, 4), np.float32)
    for b in range(B):
        for i in range(P):
            for j in range(i + 1, P):
                if rng.rand() < 0.6:
                    c = 0.3 * rng.randn(3)
                    cp[b, i, j, 0] = cp[b, j, i, 0] = 1
                    cp[b, i, j, 1:] = rmat[b, i].T @ (c - t[b, i])
                    cp[b, j, i, 1:] = rmat[b, j].T @ (c - t[b, j])
    t_pred = t.copy()
    t_pred[:, 1] += 0.5  # part 1's contacts break
    args_j = (jnp.asarray(t_pred),
              JRot(jnp.asarray(q), 'quat').convert(rot_type), jnp.asarray(cp))
    args_t = (torch.tensor(t_pred),
              TRot(torch.tensor(q), 'quat').convert(rot_type),
              torch.tensor(cp))
    ref = np.asarray(JE.calc_connectivity_acc(*args_j))
    ours = TE.calc_connectivity_acc(*args_t).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert 0.0 < ours[0] < 1.0 and ours.shape == (B, )


def test_rot_l2_loss(inputs):
    (j1, t1), (j2, t2) = _rots(inputs, 'quat')
    v = inputs['valids']
    ref = np.asarray(JL.rot_l2_loss(j1, j2, jnp.asarray(v)))
    ours = TL.rot_l2_loss(t1, t2, torch.tensor(v)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('rot_type', ['quat', 'rmat'])
def test_rot_cosine_loss(inputs, rot_type):
    (j1, t1), (j2, t2) = _rots(inputs, rot_type)
    v = inputs['valids']
    ref = np.asarray(JL.rot_cosine_loss(j1, j2, jnp.asarray(v)))
    ours = TL.rot_cosine_loss(t1, t2, torch.tensor(v)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('training', [False, True])
@pytest.mark.parametrize('rot_type', ['quat', 'rmat'])
def test_calc_loss_matches_jax(inputs, rot_type, training):
    """calc_loss(with_metrics=not training) on a raw prediction (a quat, or
    an unnormalised 6D rotation) against JAX core.calc_loss: the same key
    set, every value within its tolerance."""
    d = inputs
    pred = d['q1'] if rot_type == 'quat' else d['d6']
    gt_raw = np.asarray(JRot(jnp.asarray(d['q2']), 'quat').convert(
        rot_type).rot)
    kw = dict(rot_type=rot_type, semantic=False, training=training,
              use_rot_loss=True, use_rot_pt_l2_loss=True,
              with_metrics=not training)
    data = dict(part_pcs=d['pts'], part_valids=d['valids'],
                part_trans=d['t2'], part_rot_raw=gt_raw)
    ref = JC.calc_loss(jnp.asarray(pred), jnp.asarray(d['t1']),
                       {k: jnp.asarray(v) for k, v in data.items()}, **kw)
    ours = TC.calc_loss(torch.tensor(pred), torch.tensor(d['t1']),
                        {k: torch.tensor(v) for k, v in data.items()}, **kw)
    assert set(ours) == set(ref)
    assert (EVAL_KEYS <= set(ours)) == (not training)
    for k, v in ref.items():
        atol = 1e-3 if k.startswith('rot_') and k[4:] in METRICS else 1e-5
        if k == 'rot_mse':
            atol *= max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v),
                                   atol=atol, rtol=0, err_msg=k)
