"""The port's other geometric families as a whole: build_model over the
shipped everyday configs, weight conversion, Global, PN-Transformer-Refine
and Identity against the JAX package and the torch reference's goldens,
and every family through the trainer on the CPU (train, validate,
checkpoint, resume).

JAX pinned to f32, weights carried by convert.py, dropout off on both
sides.  Forward atol 1e-5, rtol 1e-4; gradients 1e-4 relative L2; goldens
1e-4 (Global) and 3e-4 (Refine), tests/test_golden_forward.py's.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_family_parity as U
from multi_part_assembly_tpu.models import build_model as jax_build_model
from multi_part_assembly_tpu_torch.models import (GlobalModel,
                                                  PNTransformerRefine,
                                                  build_model)
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG

torch.set_num_threads(2)

sys.path.insert(0, os.path.join(U.ROOT, 'scripts'))
FAMILIES = sorted(U.CONFIGS)


@pytest.fixture(scope='module', autouse=True)
def _f32_no_dropout():
    with U.jax_f32_no_dropout():
        yield


def _everyday(family):
    return TCFG.load_cfg_file(os.path.join(U.ROOT, U.CONFIGS[family]))


@pytest.mark.parametrize('family', FAMILIES)
def test_build_model_at_published_width(family):
    """Each family from its shipped everyday config at its published
    width, on the CPU when asked; the card is the default, and without one
    that raises."""
    cfg = _everyday(family)
    net = build_model(cfg, 'cpu')
    sd = net.state_dict()
    assert all(v.device.type == 'cpu' for v in sd.values())
    assert cfg.model.pc_feat_dim == 128
    shapes = {
        'global': {'global_enc.conv5.weight': (128, 128, 1),
                   'head.fc_layers.0.weight': (256, 256)},
        'lstm': {'seq2seq.encoder.l1_d1.wh.weight': (768, 256),
                 'seq2seq.decoder.cell0.wh.weight': (1584, 528)},
        'dgl': {'edge_mlps.2.conv1.weight': (512, 256),
                'pose_predictors.2.fc_layers.0.weight': (256, 135)},
        'rgl_net': {'grus.2.l0_d1.wi.weight': (768, 256),
                    'node_mlps.2.conv1.weight': (512, 512)},
        'pn_transformer_refine': {
            'corr.2.transformer_encoder.layers.1.linear1.weight': (512, 128),
            'corr.2.out_fc.weight': (128, 128),
            'corr_pos_enc.layers.2.weight': (128, 128),
            'head.2.fc_layers.0.weight': (256, 263)},
        'identity': {'dummy': (1, )},
    }[family]
    for k, shape in shapes.items():
        assert tuple(sd[k].shape) == shape, k
    assert not any(k.startswith(('corr.3', 'edge_mlps.3')) for k in sd)
    assert ('relation_merge.mlp1.weight' in sd) is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA'):
            build_model(cfg)


def test_build_model_raises_for_semantic_data_and_other_encoders():
    """Every encoder of the North star builds, on geometric and on
    semantic configs, and an unknown one raises; the semantic
    (partnet_chair) config builds, its DGL merging equivalent parts
    (tests/test_torch_semantic.py holds the semantic builds against JAX,
    tests/test_torch_encoder_families.py the encoders)."""
    cfg = _everyday('dgl')
    cfg.model.encoder = 'dgcnn'
    assert 'enc.conv1.0.weight' in build_model(cfg, 'cpu').state_dict()
    cfg.model.encoder = 'nosuch'
    with pytest.raises(NotImplementedError, match='nosuch'):
        build_model(cfg, 'cpu')
    cfg = TCFG.load_cfg_file(os.path.join(
        U.ROOT, 'configs/dgl/dgl-32x1-cosine_300e-partnet_chair.py'))
    net = build_model(cfg, 'cpu')
    assert net.semantic and net.merge_node
    cfg.model.encoder = 'pointnet2_ssg'
    net = build_model(cfg, 'cpu')
    assert net.semantic and 'enc.SA_modules.2.mlps.0.6.weight' in \
        net.state_dict()
    cfg.model.encoder = 'nosuch'
    with pytest.raises(NotImplementedError, match='nosuch'):
        build_model(cfg, 'cpu')


@functools.lru_cache(maxsize=None)
def _variables(family):
    jcfg, _ = U.load_cfgs(family)
    model = jax_build_model(jcfg)
    return model, U.jax_init(model, U.to_jax(U.batch()), train=False)


def _port(family, var):
    _, tcfg = U.load_cfgs(family)
    net = U.torch_no_dropout(build_model(tcfg, 'cpu'))
    net.load_state_dict(jax_to_state_dict(var, family), strict=True)
    return net, tcfg


@pytest.mark.parametrize('family', FAMILIES)
def test_convert_covers_every_tensor(family):
    _, var = _variables(family)
    _, tcfg = U.load_cfgs(family)
    sd = jax_to_state_dict(var, family)
    ours = build_model(tcfg, 'cpu').state_dict()
    assert set(sd) == set(ours)
    for k, v in ours.items():
        assert sd[k].shape == v.shape, k


@pytest.mark.parametrize('family', ['global', 'pn_transformer_refine',
                                    'identity'])
def test_eval_forward_and_logs_match_jax(family):
    model, var = _variables(family)
    jcfg, _ = U.load_cfgs(family)
    b = U.batch(1)
    ref = model.apply(var, U.to_jax(b), train=False)
    ref_logs = U.jax_mon_step(model, var, b, jcfg, training=False)
    net, tcfg = _port(family, var)
    with torch.no_grad():
        out = net.eval()(U.to_torch(b))
    for k in ('rot', 'trans'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=1e-4)
    U.assert_eval_logs_match(U.torch_mon_step(net, b, tcfg, training=False),
                             ref_logs)


@pytest.mark.parametrize('family', ['global', 'pn_transformer_refine',
                                    'identity'])
def test_train_mon_loss_and_gradients_match_jax(family):
    """One train-mode MoN loss (Refine: its supervised steps summed and
    logged as `{k}_{i}`), every gradient and the BN running statistics.
    Identity's loss reaches no parameter: its gradients are zero on both
    sides."""
    model, var = _variables(family)
    jcfg, _ = U.load_cfgs(family)
    b = U.batch(2)
    ref = U.jax_mon_step(model, var, b, jcfg)
    if family == 'pn_transformer_refine':
        assert 'rot_loss_1' in ref['logs']
    net, tcfg = _port(family, var)
    ours = U.torch_mon_step(net, b, tcfg)
    if family == 'identity':
        assert not any(g.any() for g in ours['grads'].values())
    U.assert_train_step_matches(ours, ref, var, family)


def test_global_encoder_sees_padded_points():
    """The whole-shape PointNet runs with no mask over [B, P*N, 3], padded
    zeros included, in its BN statistics too; the part PointNet does not
    see padded parts."""
    _, var = _variables('global')
    net, _ = _port('global', var)
    b = U.to_torch(U.batch(3))
    with torch.no_grad():
        feats = net.train().precompute(b)['pre_pose_feats']
        moved = dict(b)
        moved['part_pcs'] = b['part_pcs'] + 0.5 * (
            1 - b['part_valids'])[:, :, None, None]
        feats2 = net.precompute(moved)['pre_pose_feats']
    C = U.C
    valid = b['part_valids'] > 0
    assert not torch.allclose(feats[..., :C], feats2[..., :C])
    torch.testing.assert_close(feats[..., C:2 * C][valid],
                               feats2[..., C:2 * C][valid], atol=1e-6,
                               rtol=1e-5)


def test_golden_global_forward():
    from test_golden_forward import _map_head, _map_pointnet
    g = U.golden()
    enc_p, enc_s = _map_pointnet(g, 'genc')
    var = {'params': {'encoder': enc_p, 'global_encoder': enc_p,
                      'pose_predictor': _map_head(g, 'ghead')},
           'batch_stats': {'encoder': enc_s, 'global_encoder': enc_s}}
    C_g = g['genc.conv5.weight'].shape[0]
    net = GlobalModel(pc_feat_dim=C_g, noise_dim=0)
    net.load_state_dict(jax_to_state_dict(var, 'global'), strict=True)
    _check_golden(net, g, 'gl', 1e-4)


def test_golden_pn_transformer_refine_forward():
    from test_golden_forward import (_lin, _map_head, _map_pointnet,
                                     _map_transformer)
    g = U.golden()
    enc_p, enc_s = _map_pointnet(g, 'enc')
    params = {'encoder': enc_p,
              'corr_pos_enc': {'fc0': _lin(g, 'rf_pos.layers.0'),
                               'fc1': _lin(g, 'rf_pos.layers.2')}}
    for i in range(2):
        params[f'corr{i}'] = {**_map_transformer(g, f'rf_corr{i}'),
                              'out_fc': _lin(g, f'rf_corr{i}.out_fc')}
        params[f'pose{i}'] = _map_head(g, f'rf_head{i}')
    C_g = g['enc.conv5.weight'].shape[0]
    net = PNTransformerRefine(
        pc_feat_dim=C_g, noise_dim=0, transformer_feat_dim=32,
        transformer_heads=4, transformer_layers=2,
        transformer_pos_enc=(C_g, C_g), refine_steps=2)
    net.load_state_dict(jax_to_state_dict(
        {'params': params, 'batch_stats': {'encoder': enc_s}},
        'pn_transformer_refine'), strict=True)
    _check_golden(net, g, 'rf', 3e-4)


def _check_golden(net, g, prefix, atol):
    Bg, Pg = g['valids'].shape
    data = {'part_pcs': torch.tensor(g['part_pcs']),
            'part_valids': torch.tensor(g['valids']),
            'part_label': torch.zeros(Bg, Pg, 0),
            'instance_label': torch.zeros(Bg, Pg, 0)}
    with torch.no_grad():
        out = net.eval()(data)
    mask = g['valids'] > 0
    for k in ('rot', 'trans'):
        np.testing.assert_allclose(out[k].numpy()[mask],
                                   g[f'{prefix}_{k}'][mask], atol=atol,
                                   rtol=1e-4)


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    from make_synthetic_data import generate
    root = tmp_path_factory.mktemp('bb')
    os.environ['MPA_MESH_CACHE_DIR'] = str(root / 'mesh_cache')
    return generate(str(root / 'data'), n_shapes=4, min_parts=2,
                    max_parts=4, seed=0)


@pytest.mark.parametrize('family', FAMILIES)
def test_family_trains_validates_checkpoints_and_resumes_on_cpu(
        family, synth, tmp_path):
    """scripts/train_torch.py on the family's everyday config at a tiny
    size: two epochs of two steps, a validation and a checkpoint each, the
    full metric set; the run resumes on its ckp_dir.  Identity trains:
    its dummy takes zero gradients and stays 0, and Adam counts every
    step, as optax does."""
    import train_torch
    opts = ['data.data_dir', synth, 'exp.ckp_dir', str(tmp_path / 'cli'),
            'exp.num_epochs', '2', 'exp.val_every', '1', 'exp.batch_size',
            '2', 'data.max_num_part', '4', 'data.num_pc_points', '32',
            'exp.bf16', 'False', *U.NARROW[family]]
    if family == 'pn_transformer_refine':  # pos_enc (128, 128) sets 128
        i = opts.index('model.pc_feat_dim')
        del opts[i:i + 2]
    args = ['--cfg_file', os.path.join(U.ROOT, U.CONFIGS[family]),
            '--device', 'cpu', '--ckp_dir', str(tmp_path / 'run'), '--vis',
            '0', '--opts', *opts]
    first = train_torch.main(args)
    assert first.step == 4 and first.ckpt_mgr.all_steps() == [0, 1]
    keys = {f'val/{k}' for k in ('part_acc', 'loss', 'trans_rmse',
                                 'rot_rmse', 'transform_pt_cd_loss')}
    assert keys <= set(first.metrics)
    assert all(np.isfinite(v) for v in first.metrics.values())
    # every supervised iteration is logged, as `{k}_{i}`
    with open(tmp_path / 'run' / 'metrics.jsonl') as f:
        train_keys = set().union(*(json.loads(line) for line in f))
    model_cfg = first.cfg.model  # T supervised iterations a step
    T = model_cfg.get('gnn_iter', model_cfg.get('refine_steps', 1))
    assert (f'train/trans_loss_{T - 1}' in train_keys) == (T > 1)
    steps = {int(st['step']) for st in first.optimizer.state.values()}
    assert steps == {4}
    if family == 'identity':
        assert not any(p.grad.any() for p in first.model.parameters())
        assert torch.equal(first.model.dummy, torch.zeros(1))
    resumed = train_torch.main(args)
    assert resumed.start_epoch == 2 and resumed.step == 4
    for (n, a), b in zip(first.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
