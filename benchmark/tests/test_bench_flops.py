"""The FLOP count of harness/flops.py against torch's own count of the
matmuls that a train step's forward and backward run
(`torch.utils.flop_counter.FlopCounterMode`), on a small configuration
with every part valid, so that no padded slot is counted on either side."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import flops
from benchmark.tests import tiny


@pytest.mark.parametrize('config', ['pn_transformer-everyday',
                                    'pn_transformer-partnet_chair'])
def test_model_flops_match_flop_counter(config):
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.utils.config_utils import CfgNode
    cfg = tiny.config(config)
    cfg['exp']['bf16'] = False
    B = cfg['exp']['batch_size']
    P, N = cfg['data']['max_num_part'], cfg['data']['num_pc_points']
    model = build_model(CfgNode(cfg), 'cpu').train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    L = flops.label_dim(cfg)
    g = torch.Generator().manual_seed(0)
    batch = {'part_pcs': torch.randn(B, P, N, 3, generator=g),
             'part_valids': torch.ones(B, P),
             'part_label': torch.zeros(B, P, 0),
             'instance_label': torch.eye(P)[None].expand(B, P, P)[..., :L]}
    S = cfg['loss']['sample_iter']
    with FlopCounterMode(display=False) as counter:
        feats = model.precompute(batch)
        out = [model.sample(feats, batch, g) for _ in range(S)]
        loss = sum(o['rot'].sum() + o['trans'].sum() for o in out)
        loss.backward()
    assert counter.get_total_flops() == flops.model_flops(cfg, [P] * B)


def test_padded_slots_are_not_counted():
    cfg = tiny.config('pn_transformer-everyday')
    assert flops.model_flops(cfg, [2, 3]) < flops.model_flops(cfg, [6, 6])
    assert flops.model_flops(cfg, [2, 3]) == \
        flops.model_flops(cfg, [2]) + flops.model_flops(cfg, [3])


def test_chamfer_pairs_count_both_chamfers_once_a_sample():
    cfg = tiny.config('pn_transformer-partnet_chair')
    N, S = cfg['data']['num_pc_points'], cfg['loss']['sample_iter']
    assert flops.chamfer_pairs(cfg, [2]) == S * ((2 * N) ** 2 + 2 * N * N)
