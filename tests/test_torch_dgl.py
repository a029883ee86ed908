"""The port's DGL and RGL-Net families (models/dgl.py, models/rgl_net.py)
against the JAX package and the torch reference's goldens.

Modules: EdgeMLP / NodeMLP in train mode (outputs and running statistics,
batch norm over every pair with no mask), merge_equiv_nodes, RelationNet
and PoseEncoder.  Families: the eval forward and eval logs, and one
train-mode MoN loss with its gradients and BN statistics; RGL-Net's random
initial hidden states are injected on both sides.  JAX pinned to f32,
weights carried by convert.py.  Forward atol 1e-5, rtol 1e-4; gradients
1e-4 relative L2; goldens 3e-4 (tests/test_golden_forward.py's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_parity as U
from multi_part_assembly_tpu.models import build_model as jax_build_model
from multi_part_assembly_tpu.models import dgl as JD
from multi_part_assembly_tpu_torch.models import build_model, convert
from multi_part_assembly_tpu_torch.models import dgl as TD
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.models.rgl_net import RGLNet

torch.set_num_threads(2)


@pytest.fixture(scope='module', autouse=True)
def _f32_no_dropout():
    with U.jax_f32_no_dropout():
        yield


@pytest.mark.parametrize('kind', ['edge', 'node', 'node_no_final_relu'])
def test_edge_and_node_mlp_train_mode_match_jax(kind):
    """Train mode over [B, P, P, 2C] pairs: outputs, the input gradient and
    the running statistics after the step."""
    rng = np.random.RandomState(0)
    x = rng.randn(U.B, U.P, U.P, 2 * U.C).astype(np.float32)
    w = rng.randn(U.B, U.P, U.P, U.C).astype(np.float32)
    if kind == 'edge':
        jm, tm = JD.EdgeMLP(U.C), TD.EdgeMLP(2 * U.C, U.C)
    else:
        final = kind == 'node'
        jm = JD.NodeMLP(U.C, final_relu=final)
        tm = TD.NodeMLP(2 * U.C, U.C, final_relu=final)
    var = U.randomize_stats(U._unfreeze(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            train=False))), 1)

    def f(xx):
        out, mut = jm.apply(var, xx, train=True, mutable=['batch_stats'])
        return jnp.sum(out * w), (out, mut['batch_stats'])

    (_, (out, stats)), g_x = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))
    sd = {}
    convert._mlp34(sd, 'm', var['params'], var['batch_stats'])
    tm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    tx = torch.tensor(x, requires_grad=True)
    t_out = tm.train()(tx)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-4)
    (t_out * torch.tensor(w)).sum().backward()
    assert U.rel_l2(tx.grad.numpy(), g_x) <= 1e-4
    for i in range(1, 4):
        bn = getattr(tm, f'bn{i}')
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats[f'bn{i}']['mean']),
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats[f'bn{i}']['var']),
                                   atol=1e-5, rtol=1e-4)


def test_merge_equiv_nodes_matches_jax():
    """Max over each equivalence class (shared part_ids, both valid; a part
    always its own class), and the gradient, which splits evenly over a
    class's tied maxima on both sides."""
    rng = np.random.RandomState(1)
    feats = rng.randn(U.B, U.P, U.C).astype(np.float32)
    feats[1, 3] = feats[1, 1]  # a tie inside a class
    ids = np.asarray([[0, 0, 1, 1, 1, 1], [2, 5, 2, 5, 2, 0],
                      [3, 3, 3, 3, 3, 3]], np.float32)
    valids = U.batch()['part_valids']
    w = rng.randn(U.B, U.P, U.C).astype(np.float32)

    def f(x):
        out = JD.merge_equiv_nodes(x, jnp.asarray(ids), jnp.asarray(valids))
        return jnp.sum(out * w), out

    (_, ref), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(feats))
    tx = torch.tensor(feats, requires_grad=True)
    out = TD.merge_equiv_nodes(tx, torch.tensor(ids), torch.tensor(valids))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g), atol=1e-6,
                               rtol=1e-6)
    # padded parts and singleton classes keep their own features
    np.testing.assert_array_equal(out.detach().numpy()[0, 2:],
                                  feats[0, 2:])


@pytest.mark.parametrize('net', ['relation', 'pose_encoder'])
def test_relation_net_and_pose_encoder_match_jax(net):
    rng = np.random.RandomState(2)
    in_dim = 256 if net == 'relation' else 7
    x = rng.randn(U.B, U.P, U.P, in_dim).astype(np.float32)
    jm = JD.RelationNet() if net == 'relation' else JD.PoseEncoder()
    tm = TD.RelationNet(in_dim) if net == 'relation' else \
        TD.PoseEncoder(in_dim)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))['params'])
    sd = {}
    for k, p in params.items():
        convert._linear(sd, k, p)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = tm(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jm.apply({'params': params},
                                                   jnp.asarray(x))),
                               atol=1e-5, rtol=1e-4)


def _hidden(seed=4):
    """RGL-Net's initial hidden states [gnn_iter, 1, 2, B, 2C]."""
    return np.random.RandomState(seed).randn(3, 1, 2, U.B, 2 * U.C).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _variables(family):
    jcfg, _ = U.load_cfgs(family)
    model = jax_build_model(jcfg)
    if family == 'rgl_net':
        model = model.clone(hidden_noise_override=jnp.asarray(_hidden()))
    return model, U.jax_init(model, U.to_jax(U.batch()), train=False)


def _port(family, var, hidden=None):
    _, tcfg = U.load_cfgs(family)
    net = U.torch_no_dropout(build_model(tcfg, 'cpu'))
    net.load_state_dict(jax_to_state_dict(var, family), strict=True)
    if hidden is not None:
        net.hidden_noise_override = torch.tensor(hidden)
    return net, tcfg


@pytest.mark.parametrize('family', ['dgl', 'rgl_net'])
def test_eval_forward_and_logs_match_jax(family):
    model, var = _variables(family)
    jcfg, _ = U.load_cfgs(family)
    b = U.batch(1)
    ref = model.apply(var, U.to_jax(b), train=False)
    ref_logs = U.jax_mon_step(model, var, b, jcfg, training=False)
    net, tcfg = _port(family, var, _hidden() if family == 'rgl_net' else None)
    with torch.no_grad():
        out = net.eval()(U.to_torch(b))
    for k in ('rot', 'trans'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=1e-4)
    U.assert_eval_logs_match(U.torch_mon_step(net, b, tcfg, training=False),
                             ref_logs)


@pytest.mark.parametrize('family', ['dgl', 'rgl_net'])
def test_train_mon_loss_and_gradients_match_jax(family):
    """One train-mode MoN loss over the three supervised rounds (each
    logged as `{k}_{i}`), the running statistics that the encoder and the
    edge and node MLPs leave, and every gradient.  Those batch norms run
    over every row with the batch's statistics, which makes this gradient
    ill-conditioned at this size: the JAX gradient itself moves by 1e-4 to
    1e-2 when the clouds move by one ulp (measured on seeds 2-8).  So the
    gradient is held to 1e-4 relative L2 plus twice the JAX gradient's own
    movement under 1e-7 and 1e-6 nudges of the clouds; the eval-mode test
    below holds the same backward at 1e-4 alone."""
    model, var = _variables(family)
    jcfg, _ = U.load_cfgs(family)
    b = U.batch(2)
    ref = U.jax_mon_step(model, var, b, jcfg)
    assert 'rot_loss_2' in ref['logs']
    resolution = U.jax_gradient_resolution(model, var, b, jcfg)
    assert resolution < 1e-2
    net, tcfg = _port(family, var, _hidden() if family == 'rgl_net' else None)
    U.assert_train_step_matches(U.torch_mon_step(net, b, tcfg), ref, var,
                                family, grad_tol=1e-4 + 2 * resolution)


@pytest.mark.parametrize('family', ['dgl', 'rgl_net'])
def test_eval_mode_gradients_match_jax(family):
    """The gradients of the eval-mode MoN loss (batch norms on their running
    statistics, the last round's pose), 1e-4 relative L2 per parameter."""
    model, var = _variables(family)
    jcfg, _ = U.load_cfgs(family)
    net, tcfg = _port(family, var, _hidden() if family == 'rgl_net' else None)
    ours, ref = U.eval_gradients(model, var, net, U.batch(2), jcfg, tcfg,
                                 family)
    U.assert_gradients_match(ours, ref, 1e-4)


def test_train_mode_stacks_rounds_and_rgl_draws_from_the_generator():
    """Train mode returns [T, B, P, .]; without an override RGL-Net draws
    its initial hidden states from the generator, so one seed gives one
    forward and another seed another."""
    _, var = _variables('rgl_net')
    net, _ = _port('rgl_net', var)
    data = U.to_torch(U.batch(3))
    with torch.no_grad():
        outs = [net.train()(data, torch.Generator().manual_seed(s))['rot']
                for s in (0, 0, 1)]
    assert outs[0].shape == (3, U.B, U.P, 4)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def _golden_variables(g, family):
    """The torch reference's DGL / RGL-Net weights as JAX variables, by
    tests/test_golden_forward.py's maps."""
    from test_golden_forward import (_lin, _map_gru, _map_head, _map_mlp34,
                                     _map_pointnet)
    enc_p, enc_s = _map_pointnet(g, 'denc')
    params, stats = {'encoder': enc_p}, {'encoder': enc_s}
    node = 'dnode' if family == 'dgl' else 'rnode'
    for i in range(3):
        for role, pre in (('edge_mlp', 'dedge'), ('node_mlp', node)):
            params[f'{role}{i}'], stats[f'{role}{i}'] = \
                _map_mlp34(g, f'{pre}{i}')
        params[f'pose{i}'] = _map_head(g, f'dhead{i}')
        if family == 'rgl_net':
            params[f'gru{i}'] = _map_gru(g, f'rgru{i}', num_layers=1)
    for name, pre in (('relation_dense', 'drel_dense'),
                      ('relation_merge', 'drel_merge')):
        params[name] = {f'mlp{i}': _lin(g, f'{pre}.mlp{i}')
                        for i in (1, 2, 3)}
    params['pose_extractor'] = {f'mlp{i}': _lin(g, f'dpose_enc.mlp{i}')
                                for i in (1, 2)}
    return {'params': params, 'batch_stats': stats}


@pytest.mark.parametrize('family', ['dgl', 'rgl_net'])
def test_golden_forward(family):
    """The torch reference's composed eval forward with the semantic merge
    on (the dense masked merge against its class-list loop), instance
    labels, and for RGL-Net its recorded initial hidden states."""
    g = U.golden()
    Bg, Pg = g['valids'].shape
    C_g = g['denc.conv5.weight'].shape[0]
    kw = dict(rot_type='quat', pc_feat_dim=C_g, noise_dim=0, gnn_iter=3,
              merge_node=True, semantic=True, label_dim=Pg)
    net = TD.DGLModel(**kw) if family == 'dgl' else RGLNet(
        **kw, hidden_noise_override=torch.tensor(
            g['rgl_hidden']).reshape(3, 1, 2, Bg, 2 * C_g))
    net.load_state_dict(jax_to_state_dict(_golden_variables(g, family),
                                          family), strict=True)
    data = {'part_pcs': torch.tensor(g['part_pcs']),
            'part_valids': torch.tensor(g['valids']),
            'part_label': torch.zeros(Bg, Pg, 0),
            'instance_label': torch.tensor(g['dgl_instance_label']),
            'part_ids': torch.tensor(g['dgl_part_ids']),
            'valid_matrix': torch.tensor(g['dgl_valid_matrix'])}
    with torch.no_grad():
        out = net.eval()(data)
    mask = g['valids'] > 0
    pre = 'dgl' if family == 'dgl' else 'rgl'
    for k in ('rot', 'trans'):
        np.testing.assert_allclose(out[k].numpy()[mask],
                                   g[f'{pre}_{k}'][mask], atol=3e-4,
                                   rtol=1e-4)


def test_golden_edge_mlp_train_bn():
    """Train-mode MLP3 against the reference's torch BN over every pair
    entry: outputs (3e-4) and running statistics (1e-5), as
    tests/test_golden_forward.py::test_edge_mlp_train_bn_parity."""
    from test_golden_forward import _map_mlp34
    g = U.golden()
    params, stats = _map_mlp34(g, 'tedge')
    x = g['tedge_in']
    mlp = TD.EdgeMLP(x.shape[-1], g['tedge_out'].shape[-1])
    sd = {}
    convert._mlp34(sd, 'm', params, stats)
    mlp.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = mlp.train()(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), g['tedge_out'], atol=3e-4,
                               rtol=1e-4)
    for i in range(1, 4):
        bn = getattr(mlp, f'bn{i}')
        for ours, theirs in (('running_mean', 'running_mean'),
                             ('running_var', 'running_var')):
            np.testing.assert_allclose(
                getattr(bn, ours).numpy(), g[f'tedge_post.bn{i}.{theirs}'],
                atol=1e-5, rtol=1e-4)
