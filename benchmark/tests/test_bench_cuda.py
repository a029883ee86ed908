"""On the card: a small run of each cell through the graphed step comes out
correct, with the program in bf16 against the f32 reference and the
cells' limits; a dropout mask drawn on a tensor of ones is the mask the
program's dropout draws.  Each test decides inside itself whether a card
is there."""

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import cell as harness_cell
from benchmark.harness import spec
from benchmark.tests import tiny


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
def test_dropout_mask_is_drawn_again():
    _card()
    x = torch.randn(3, 8, 20, 20, device='cuda', dtype=torch.bfloat16)
    torch.cuda.manual_seed(5)
    y = F.dropout(x, 0.1, training=True)
    torch.cuda.manual_seed(5)
    keep = F.dropout(torch.ones_like(x), 0.1, training=True) != 0
    assert torch.equal(y != 0, keep & (x != 0))


@pytest.mark.cuda
@pytest.mark.parametrize('cell', sorted(tiny.CELLS))
def test_small_cell_on_the_card(cell, tmp_path, monkeypatch):
    _card()
    monkeypatch.setattr(spec, 'CACHE', str(tmp_path))
    monkeypatch.setenv('MPA_MESH_CACHE_DIR', str(tmp_path / 'mesh'))
    config, traffic = tiny.CELLS[cell]
    cfg = tiny.config(config)
    cfg['exp']['bf16'] = False
    t = tiny.traffic(traffic)
    # epoch 0 holds the checked steps: on the card a slot wire dispatches
    # groups of 8 replays, so the first step and one group
    steps = harness_cell.check_steps(8 if t['wire'] == 'slot' else 1)
    t['data']['n_train'] = max(t['data']['n_train'],
                               steps * cfg['exp']['batch_size'])
    out = harness_cell.run(cfg, t, tiny.limits(cell),
                           spec.per_layer(cell), 7, 1.0, True, device='cuda',
                           log=lambda m: None)
    assert out['correct'], out['checks']
    assert out['device']['busy_s'] > 0
    assert 0 < out['metrics']['chamfer_roofline']['value'] <= 100
