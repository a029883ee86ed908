"""The control of the correctness check comes out as not correct: the
reference rounded to fp8 (e4m3) wherever it rounds to bf16, the precision
below the configurations', put in the program's place, against the
reference in the configuration's bf16, under each cell's limits, over the
cell's checked steps, at a size a test can hold.  The
cells' own sizes are read on the card (benchmark/calibrate.py, PERF.md)."""

import pytest
import torch

from benchmark.harness import cell as harness_cell
from benchmark.harness import compare, spec
from benchmark.harness.weights import make_weights
from benchmark.reference.loss import loss_weights
from benchmark.reference.train import run_steps
from benchmark.tests import tiny


@pytest.mark.parametrize('cell', sorted(tiny.CELLS))
@pytest.mark.parametrize('seed', [3, 2**31 + 11])
def test_fp8_control_is_not_correct(cell, seed, tmp_path, monkeypatch):
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.utils.config_utils import CfgNode
    monkeypatch.setattr(spec, 'CACHE', str(tmp_path))
    config, traffic = tiny.CELLS[cell]
    t = tiny.traffic(traffic)
    # the checked steps of the cell on a card: 8 replays a group on a slot
    # wire, one on the host wire; epoch 0 holds them
    steps = harness_cell.check_steps(8 if t['wire'] == 'slot' else 1)
    t['data']['n_train'] = steps * tiny.config(config)['exp']['batch_size']
    cfg = spec.run_config(tiny.config(config), t, spec.ensure_data(t), seed)
    shapes = [(n, tuple(p.shape)) for n, p in
              build_model(CfgNode(cfg), 'cpu').named_parameters()]
    p0 = make_weights(shapes, seed, torch.device('cpu'))
    ref = run_steps(cfg, t['wire'], p0, seed, steps, torch.device('cpu'))
    ctl = run_steps(cfg, t['wire'], p0, seed, steps, torch.device('cpu'),
                    precision='fp8')
    weights = loss_weights(cfg)
    correct, checks = compare.judge(compare.readings(ctl, ref, p0, weights),
                                    tiny.limits(cell))
    assert not correct, checks
    # the reference against itself reads exactly nought
    same = compare.readings(ref, ref, p0, weights)
    assert set(same.values()) == {0.0}
