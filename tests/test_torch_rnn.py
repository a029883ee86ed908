"""The port's FusedGRUCell and MaskedGRU (models/modules/rnn.py) against the
JAX package's and the torch reference's packed nn.GRU golden.

The same numpy inputs go through both; JAX weights are carried over with
models/convert.py.  Forward atol 1e-5, rtol 1e-4; gradients 1e-4 relative
L2.  Ragged prefix masks (2, 6 and 4 valid steps of 6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_part_assembly_tpu.models.modules.rnn import \
    FusedGRUCell as JaxCell
from multi_part_assembly_tpu.models.modules.rnn import MaskedGRU as JaxGRU
from multi_part_assembly_tpu_torch.models import convert
from multi_part_assembly_tpu_torch.models.modules.rnn import (FusedGRUCell,
                                                              MaskedGRU)
from torch_family_parity import golden

torch.set_num_threads(2)

B, T, C, H = 3, 6, 16, 20
COUNTS = (2, 6, 4)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    valids = (np.arange(T)[None] <
              np.asarray(COUNTS)[:, None]).astype(np.float32)
    x = rng.randn(B, T, C).astype(np.float32)
    return x, valids, rng


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _state_dict(params):
    sd = {}
    convert._gru(sd, 'gru', params)
    return {k[len('gru.'):]: v for k, v in sd.items()}


def test_fused_gru_cell_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(B, C).astype(np.float32)
    h = rng.randn(B, H).astype(np.float32)
    cell = JaxCell(H)
    params = cell.init(jax.random.PRNGKey(0), jnp.asarray(h),
                       jnp.asarray(x))['params']
    # a non-zero n-gate hidden bias, so that its place is tested
    params = {**params, 'bhn': jnp.asarray(rng.randn(H).astype(np.float32))}
    w = rng.randn(B, H).astype(np.float32)

    def f(p, hh, xx):
        return jnp.sum(cell.apply({'params': p}, hh, xx) * w)

    ref = cell.apply({'params': params}, jnp.asarray(h), jnp.asarray(x))
    g_p, g_h, g_x = jax.grad(f, argnums=(0, 1, 2))(
        params, jnp.asarray(h), jnp.asarray(x))
    ours = FusedGRUCell(C, H)
    sd = {}
    convert._gru_cell(sd, 'c', params)
    ours.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    th = torch.tensor(h, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out = ours(th, tx)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-4)
    assert _rel_l2(th.grad.numpy(), np.asarray(g_h)) <= 1e-4
    assert _rel_l2(tx.grad.numpy(), np.asarray(g_x)) <= 1e-4
    sd_g = {}
    convert._gru_cell(sd_g, 'c', g_p)
    for name, p in ours.named_parameters():
        assert _rel_l2(p.grad.numpy(), sd_g[f'c.{name}'].numpy()) <= 1e-4, \
            name


@functools.lru_cache(maxsize=None)
def _jax_gru(num_layers, bidirectional):
    """JAX MaskedGRU, its params (numpy), the inputs and its outputs and
    gradients, cached per shape (read them, never modify them)."""
    x, valids, rng = _inputs(num_layers + 2 * bidirectional)
    dirs = 2 if bidirectional else 1
    h0 = rng.randn(num_layers, dirs, B, H).astype(np.float32)
    w = rng.randn(B, T, H * dirs).astype(np.float32)
    wh = rng.randn(num_layers, dirs, B, H).astype(np.float32)
    gru = JaxGRU(hidden_size=H, num_layers=num_layers,
                 bidirectional=bidirectional)
    params = gru.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      train=False)['params']

    def f(p, xx, hh):
        out, h_n = gru.apply({'params': p}, xx, hh, jnp.asarray(valids),
                             train=False)
        return jnp.sum(out * w) + jnp.sum(h_n * wh), (out, h_n)

    (_, (out, h_n)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x),
                                            jnp.asarray(h0))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(params=to_np(params), x=x, valids=valids, h0=h0, w=w, wh=wh,
                out=np.asarray(out), h_n=np.asarray(h_n), grads=to_np(grads))


@pytest.mark.parametrize('num_layers,bidirectional',
                         [(1, False), (1, True), (2, True)])
def test_masked_gru_matches_jax(num_layers, bidirectional):
    """Outputs, last hidden states and every gradient (weights, input and
    initial hidden), ragged prefix masks."""
    ref = _jax_gru(num_layers, bidirectional)
    gru = MaskedGRU(C, H, num_layers=num_layers, bidirectional=bidirectional)
    gru.load_state_dict(_state_dict(ref['params']), strict=True)
    x = torch.tensor(ref['x'], requires_grad=True)
    h0 = torch.tensor(ref['h0'], requires_grad=True)
    out, h_n = gru(x, h0, torch.tensor(ref['valids']))
    np.testing.assert_allclose(out.detach().numpy(), ref['out'], atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(h_n.detach().numpy(), ref['h_n'], atol=1e-5,
                               rtol=1e-4)
    ((out * torch.tensor(ref['w'])).sum() +
     (h_n * torch.tensor(ref['wh'])).sum()).backward()
    g_params, g_x, g_h = ref['grads']
    assert _rel_l2(x.grad.numpy(), g_x) <= 1e-4
    assert _rel_l2(h0.grad.numpy(), g_h) <= 1e-4
    sd = _state_dict(g_params)
    for name, p in gru.named_parameters():
        assert _rel_l2(p.grad.numpy(), sd[name].numpy()) <= 1e-4, name


def test_padded_steps_emit_zeros_and_keep_the_hidden_state():
    """A padded step emits zeros and carries the hidden state through: the
    last hidden state of a row is that of its last valid step, and padded
    inputs change nothing."""
    x, valids, _ = _inputs()
    torch.manual_seed(0)
    gru = MaskedGRU(C, H, num_layers=2, bidirectional=True)
    v = torch.tensor(valids)
    out, h_n = gru(torch.tensor(x), None, v)
    pad = v == 0
    assert torch.all(out[pad] == 0)
    x2 = torch.tensor(x) + 3.0 * (1 - v)[..., None]
    out2, h_n2 = gru(x2, None, v)
    torch.testing.assert_close(out2, out, atol=0, rtol=0)
    torch.testing.assert_close(h_n2, h_n, atol=0, rtol=0)
    # row 0 (2 valid steps) alone, unpadded: the same forward hidden
    out0, h0 = gru(torch.tensor(x[:1, :2]))
    torch.testing.assert_close(out0, out[:1, :2], atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(h0, h_n[:, :, :1], atol=1e-6, rtol=1e-5)


def test_inter_layer_dropout_in_train_mode_only():
    x, valids, _ = _inputs()
    torch.manual_seed(0)
    gru = MaskedGRU(C, H, num_layers=2, bidirectional=True, dropout=0.5)
    args = (torch.tensor(x), None, torch.tensor(valids))
    with torch.no_grad():
        ref = gru.eval()(*args)[0]
        torch.testing.assert_close(gru(*args)[0], ref, atol=0, rtol=0)
        gru.drop.p = 0.0
        torch.testing.assert_close(gru.train()(*args)[0], ref, atol=0,
                                   rtol=0)
        gru.drop.p = 0.5
        assert not torch.allclose(gru(*args)[0], ref)


def test_golden_masked_gru():
    """Against torch's packed bidirectional 2-layer nn.GRU (the reference's
    RNNWrapper), its weights carried over by the JAX golden test's map and
    convert.py (tests/test_golden_forward.py::test_masked_gru_forward_parity
    pins the JAX side at atol 1e-5)."""
    from test_golden_forward import _map_gru
    g = golden()
    C_g = g['gru_x'].shape[-1]
    gru = MaskedGRU(C_g, C_g, num_layers=2, bidirectional=True).eval()
    gru.load_state_dict(_state_dict(_map_gru(g, 'gru')), strict=True)
    with torch.no_grad():
        out, h_n = gru(torch.tensor(g['gru_x']), None,
                       torch.tensor(g['valids']))
    np.testing.assert_allclose(out.numpy(), g['gru_out'], atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(h_n.numpy(), g['gru_hn'], atol=1e-5,
                               rtol=1e-4)
