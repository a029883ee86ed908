"""The plain reference against the repository's goldens: the
PN-Transformer's transformer and pose head (tests/golden/
forward_values.npz, the torch reference repository's eval-mode forward)
and the losses (tests/golden/reference_values.npz)."""

import os

import numpy as np
import pytest
import torch

from benchmark.reference import loss as L
from benchmark.reference import model as M

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'tests', 'golden')


def _load(name):
    with np.load(os.path.join(GOLDEN, name)) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def _eval_pointnet(g, pcs):
    """The encoder with the goldens' running statistics (eval mode)."""
    x = pcs
    for i in range(1, 6):
        x = M.Precision('f32').linear(x, g[f'enc.conv{i}.weight'][:, :, 0])
        p = f'enc.bn{i}'
        x = (x - g[f'{p}.running_mean']) / torch.sqrt(
            g[f'{p}.running_var'] + 1e-5) * g[f'{p}.weight'] + g[f'{p}.bias']
        if i < 5:
            x = torch.relu(x)
    return x.amax(1)


def test_forward_matches_golden():
    g = _load('forward_values.npz')
    pcs, valids = g['part_pcs'], g['valids']
    valid = valids > 0
    feats = torch.zeros(g['pn_pc_feats'].shape)
    feats[valid] = _eval_pointnet(g, pcs[valid])
    torch.testing.assert_close(feats, g['pn_pc_feats'], atol=1e-4, rtol=1e-4)
    layers = 1 + max(int(k.split('.')[3]) for k in g
                     if k.startswith('corr.transformer_encoder.layers.'))
    drop = M.Dropout(0.1, torch.float32, enabled=False)
    corr = M.transformer(g, g['pn_pc_feats'], valid, 4, layers,
                         M.Precision('f32'), drop)
    torch.testing.assert_close(corr, g['pn_corr_feats'], atol=1e-4,
                               rtol=1e-4)
    rot, trans = M.pose_head(g, g['pn_corr_feats'], M.Precision('f32'))
    torch.testing.assert_close(rot, g['pn_rot'], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(trans, g['pn_trans'], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('name,key', [
    ('trans_loss', 'trans_l2_loss'),
    ('rot_pt_cd_loss', 'rot_points_cd_loss'),
    ('transform_pt_cd_loss', 'shape_cd_loss_train'),
    ('rot_loss', 'rot_cosine_loss_quat'),
    ('rot_pt_l2_loss', 'rot_points_l2_loss')])
def test_losses_match_golden(name, key):
    g = _load('reference_values.npz')
    out = L.losses(g['pts'], g['valids'], g['quat1'], g['trans1'],
                   g['quat2'], g['trans2'], use_rot_loss=True,
                   use_rot_pt_l2=True)
    torch.testing.assert_close(out[name], g[key], atol=1e-5, rtol=1e-4)


def test_fp8_control_rounds_matmul_operands():
    x = torch.tensor([1.0, 1.03, -300.0, 448.0])
    q = M.fp8(x)
    assert q[0] == 1.0 and q[1] != x[1] and q[3] == 448.0
    x.requires_grad_()
    M.fp8(x).sum().backward()
    assert torch.equal(x.grad, torch.ones(4))
