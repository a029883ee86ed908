"""The port's Seq2Seq and LSTM family (models/lstm.py) against the JAX
package and the torch reference's Seq2Seq golden.

The JAX model draws its decoder hidden noise and teacher-forcing flag from
its 'noise' stream; the tests replace both draws (jax.random.normal for
the [2, B, 16] noise, jax.random.bernoulli for the flag) and give the port
the same values through its overrides.  Dropout off on both sides, f32.
Forward atol 1e-5, rtol 1e-4; gradients 1e-4 relative L2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_parity as U
from multi_part_assembly_tpu.models import build_model as jax_build_model
from multi_part_assembly_tpu.models.lstm import Seq2Seq as JaxSeq2Seq
from multi_part_assembly_tpu_torch.models import build_model, convert
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.models.lstm import Seq2Seq

torch.set_num_threads(2)

HID = 20  # encoder hidden size of the small Seq2Seq
NOISE = 16


def _noise(seed=5):
    return np.random.RandomState(seed).randn(2, U.B, NOISE).astype(
        np.float32)


def _fix_draws(mp, noise, teacher_force):
    """Replace the JAX model's hidden-noise and teacher-forcing draws."""
    normal = jax.random.normal
    mp.setattr(jax.random, 'normal',
               lambda key, shape=(), dtype=jnp.float32: jnp.asarray(noise)
               if tuple(shape) == noise.shape else normal(key, shape, dtype))
    mp.setattr(jax.random, 'bernoulli',
               lambda key, p=0.5, shape=None: jnp.asarray(teacher_force))


def _seq2seq_sd(params):
    sd = {}
    convert._seq2seq(sd, 's', params)
    return {k[2:]: v for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _jax_seq2seq_params():
    x = np.random.RandomState(0).randn(U.B, U.P, U.C).astype(np.float32)
    s2s = JaxSeq2Seq(feat_dim=U.C, hidden_size=HID)
    params = s2s.init({'params': jax.random.PRNGKey(0),
                       'noise': jax.random.PRNGKey(1),
                       'dropout': jax.random.PRNGKey(2)}, jnp.asarray(x),
                      jnp.asarray(x), train=False)['params']
    return s2s, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize('train,teacher_force',
                         [(False, False), (True, False), (True, True)])
def test_seq2seq_matches_jax(train, teacher_force):
    """Outputs and stop signs, hidden noise injected, ragged valids; in
    train mode with the teacher-forcing flag fixed, and the gradients of
    every weight and of the input sequence (the target is detached)."""
    s2s, params = _jax_seq2seq_params()
    rng = np.random.RandomState(1)
    x = rng.randn(U.B, U.P, U.C).astype(np.float32)
    target = rng.randn(U.B, U.P, U.C).astype(np.float32)
    valids = U.batch()['part_valids']
    noise = _noise()
    w = rng.randn(U.B, U.P, U.C).astype(np.float32)
    with U.jax_f32_no_dropout() as mp:
        _fix_draws(mp, noise, teacher_force)

        def f(p, xx):
            out, stop = s2s.apply(
                {'params': p}, xx, jnp.asarray(target),
                valids=jnp.asarray(valids), train=train,
                rngs={'noise': jax.random.PRNGKey(3),
                      'dropout': jax.random.PRNGKey(4)})
            return jnp.sum(out * w) + jnp.sum(stop), (out, stop)

        (_, (out, stop)), (g_p, g_x) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    net = U.torch_no_dropout(Seq2Seq(U.C, hidden_size=HID))
    net.load_state_dict(_seq2seq_sd(params), strict=True)
    net.train(train)
    tx = torch.tensor(x, requires_grad=True)
    t_out, t_stop = net(tx, torch.tensor(target), torch.tensor(valids),
                        hidden_noise=torch.tensor(noise),
                        teacher_force=teacher_force)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(t_stop.detach().numpy(), np.asarray(stop),
                               atol=1e-5, rtol=1e-4)
    ((t_out * torch.tensor(w)).sum() + t_stop.sum()).backward()
    assert U.rel_l2(tx.grad.numpy(), np.asarray(g_x)) <= 1e-4
    sd = _seq2seq_sd(jax.tree_util.tree_map(np.asarray, g_p))
    for name, p in net.named_parameters():
        if p.grad is None:  # the decoder's second cell feeds no output
            assert not sd[name].any(), name
            continue
        assert U.rel_l2(p.grad.numpy(), sd[name].numpy()) <= 1e-4, name


def test_teacher_forcing_is_one_draw_a_forward():
    """Without an override the flag is one Bernoulli draw from the
    generator for the whole forward: each output equals the forced-on or
    the forced-off forward, and both occur over a few seeds."""
    torch.manual_seed(0)
    net = U.torch_no_dropout(Seq2Seq(U.C, hidden_size=HID)).train()
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(U.B, U.P, U.C).astype(np.float32))
    target = torch.tensor(rng.randn(U.B, U.P, U.C).astype(np.float32))
    noise = torch.tensor(_noise())
    with torch.no_grad():
        forced = [net(x, target, hidden_noise=noise, teacher_force=tf)[0]
                  for tf in (False, True)]
        seen = set()
        for seed in range(8):
            g = torch.Generator().manual_seed(seed)
            out = net(x, target, generator=g, hidden_noise=noise)[0]
            hits = [i for i, f in enumerate(forced) if torch.equal(out, f)]
            assert len(hits) == 1
            seen.add(hits[0])
        assert seen == {0, 1}
        # eval never forces, whatever the override
        net.eval()
        torch.testing.assert_close(
            net(x, target, hidden_noise=noise, teacher_force=True)[0],
            forced[0], atol=0, rtol=0)


@functools.lru_cache(maxsize=None)
def _lstm_variables():
    jcfg, _ = U.load_cfgs('lstm')
    model = jax_build_model(jcfg)
    with U.jax_f32_no_dropout() as mp:
        _fix_draws(mp, _noise(), False)
        var = U.jax_init(model, U.to_jax(U.batch()), train=False)
    return model, var


def _port_lstm(var, noise, teacher_force):
    _, tcfg = U.load_cfgs('lstm')
    net = U.torch_no_dropout(build_model(tcfg, 'cpu'))
    net.load_state_dict(jax_to_state_dict(var, 'lstm'), strict=True)
    net.hidden_noise_override = torch.tensor(noise)
    net.teacher_force_override = teacher_force
    return net, tcfg


def test_lstm_eval_forward_and_logs_match_jax():
    model, var = _lstm_variables()
    jcfg, _ = U.load_cfgs('lstm')
    b = U.batch(1)
    noise = _noise(6)
    with U.jax_f32_no_dropout() as mp:
        _fix_draws(mp, noise, False)
        ref = model.apply(var, U.to_jax(b), train=False,
                          rngs={'noise': jax.random.PRNGKey(0)})
        ref_logs = U.jax_mon_step(model, var, b, jcfg, training=False)
    net, tcfg = _port_lstm(var, noise, None)
    with torch.no_grad():
        out = net.eval()(U.to_torch(b))
    for k in ('rot', 'trans'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=1e-4)
    U.assert_eval_logs_match(U.torch_mon_step(net, b, tcfg, training=False),
                             ref_logs)


@pytest.mark.parametrize('teacher_force', [False, True])
def test_lstm_train_mon_loss_and_gradients_match_jax(teacher_force):
    """One train-mode MoN loss, its gradients (the stop-sign head's are
    zero on both sides) and the encoder's BN running statistics."""
    model, var = _lstm_variables()
    jcfg, _ = U.load_cfgs('lstm')
    b = U.batch(2)
    noise = _noise(7)
    with U.jax_f32_no_dropout() as mp:
        _fix_draws(mp, noise, teacher_force)
        ref = U.jax_mon_step(model, var, b, jcfg)
    net, tcfg = _port_lstm(var, noise, teacher_force)
    U.assert_train_step_matches(U.torch_mon_step(net, b, tcfg), ref, var,
                                'lstm')


def test_golden_seq2seq():
    """The torch reference's Seq2Seq (teacher forcing off, its recorded
    hidden noise), weights carried by the JAX golden test's map and
    convert.py (tests/test_golden_forward.py::test_seq2seq_forward_parity
    pins the JAX side at 1e-4)."""
    from test_golden_forward import _lin, _map_gru, _map_gru_cell
    g = U.golden()
    params = {
        'encoder': _map_gru(g, 'ls2s.encoder.rnn.gru'),
        'decoder': {
            'cell0': _map_gru_cell(g, 'ls2s.decoder.gru', '_l0'),
            'cell1': _map_gru_cell(g, 'ls2s.decoder.gru', '_l1'),
            'lin1a': _lin(g, 'ls2s.decoder.linear1.0'),
            'lin1b': _lin(g, 'ls2s.decoder.linear1.2'),
            'lin3a': _lin(g, 'ls2s.decoder.linear3.0'),
            'lin3b': _lin(g, 'ls2s.decoder.linear3.3'),
        },
    }
    C_g = g['gru_x'].shape[-1]
    net = Seq2Seq(C_g, hidden_size=20).eval()
    net.load_state_dict(_seq2seq_sd(params), strict=True)
    x = torch.tensor(g['gru_x'])
    with torch.no_grad():
        out, stop = net(x, x, torch.tensor(g['valids']),
                        hidden_noise=torch.tensor(g['ls2s_noise']))
    np.testing.assert_allclose(out.numpy(), g['ls2s_out'], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(stop.numpy(), g['ls2s_stop'], atol=1e-4,
                               rtol=1e-4)
