"""A run of each cell, the harness's look for a card skipped, at a size a
test can hold, on the CPU with the program in f32: sound, it comes out
correct; with the timed path broken underneath, not correct, once for each
fault a training cell can have on one chip: a step that leaves the
weights unchanged, half of the batch left out (the mean over the rest),
and the points of a part altered where the batch is placed."""

import pytest
import torch

from benchmark.harness import cell as harness_cell
from benchmark.harness import spec
from benchmark.tests import tiny


def _run(cell, tmp_path, monkeypatch, seed=2**31 + 5):
    monkeypatch.setattr(spec, 'CACHE', str(tmp_path))
    monkeypatch.setenv('MPA_MESH_CACHE_DIR', str(tmp_path / 'mesh'))
    config, traffic = tiny.CELLS[cell]
    cfg = tiny.config(config)
    cfg['exp']['bf16'] = False
    t = tiny.traffic(traffic)
    if t['wire'] == 'slot':  # 'auto' is on for CUDA only
        key = 'device_sampling' if t['data']['kind'] == 'geometry' \
            else 'device_table'
        t['options'] = {key: True}
        cfg['exp']['steps_per_call'] = 2  # the checked group, as on a card
    return harness_cell.run(cfg, t, tiny.limits(cell), [], seed, 0.2, False,
                            device='cpu', log=lambda m: None)


def _unchanged(monkeypatch):
    step = torch.optim.Adam.step

    def frozen(self, *args, **kwargs):
        before = [p.detach().clone() for g in self.param_groups
                  for p in g['params']]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for p, b in zip((p for g in self.param_groups
                             for p in g['params']), before):
                p.copy_(b)
        return out
    monkeypatch.setattr(torch.optim.Adam, 'step', frozen)


def _half(monkeypatch):
    import multi_part_assembly_tpu_torch.train.step as step_mod
    loss = step_mod.mon_loss

    def half(model, data, **kw):
        n = data['part_valids'].shape[0] // 2
        return loss(model, {k: v[:n] for k, v in data.items()}, **kw)
    monkeypatch.setattr(step_mod, 'mon_loss', half)


def _altered(monkeypatch):
    import multi_part_assembly_tpu_torch.train.trainer as trainer_mod
    place = trainer_mod.device_batch

    def altered(batch, cfg, device):
        out = place(batch, cfg, device)
        key = 'part_pcs_raw' if 'part_pcs_raw' in out else 'part_pcs'
        out[key] = out[key].clone()
        out[key][:, 0] *= 0.5
        return out
    monkeypatch.setattr(trainer_mod, 'device_batch', altered)


@pytest.mark.parametrize('cell', sorted(tiny.CELLS))
@pytest.mark.parametrize('fault', [None, _unchanged, _half, _altered],
                         ids=['sound', 'unchanged', 'half', 'altered'])
def test_fault_makes_run_not_correct(cell, fault, tmp_path, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    out = _run(cell, tmp_path, monkeypatch)
    assert out['correct'] is (fault is None), out['checks']
    assert out['failed'] == 0 and out['attempted'] > 0
