"""The reference RGL-Net (reference/families/rgl_net.py) against the
program's, on the CPU at a small size: B 3, P 5, N 64, F 16, `gnn_iter` 3,
the cell's configuration otherwise.

The program is set up as a run sets it up (harness/cell.py `build`: the
trainer, the seed's weights from `make_weights`, epoch 0 with its checked
steps, the first alone, then a group of two), and the reference follows
the same three steps from the same weights and data.  Compared: each
step's loss terms, the first gradient leaf by leaf, the weights after the
three steps; in f32, and with `exp.bf16` at the reference's bf16 rounding
points.  A run of the cell at this size under the cell's limits: correct
when sound, not correct with a fault planted or with the fp8 control in
the program's place.  The FLOP count against `FlopCounterMode` on the
program's train step with every part valid, and the cell's chamfers a
step.
"""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import cell as harness_cell
from benchmark.harness import compare, flops, spec
from benchmark.harness.weights import make_weights
from benchmark.reference.families import family
from benchmark.reference.loss import loss_weights
from benchmark.reference.train import run_steps
from benchmark.tests.test_bench_faults import _altered, _half, _unchanged

CELL = 'rgl_net-everyday-slot'
CONFIG = 'rgl_net-everyday'
TRAFFIC = 'everyday_slot'
B, P, N, F = 3, 5, 64, 16
SEEDS = [2**31 + 3, 17]

# Each number is harness/compare.py's (`readings`), the worst leaf's first
# gradient beside them.  Seen on the CPU on two seeds: f32, step 1's
# loss 7.9e-8-2.8e-7, the worst leaf's gradient 7.6e-6-1.8e-5, later
# steps 2.0e-3-3.3e-3, the change 7.5e-3-3.2e-2; bf16, step 1's loss
# 6.3e-8-6.9e-8, the median leaf's gradient 8.3e-4-1.1e-3, later steps
# 1.5e-2-2.8e-2, the change 5.1e-2-7.1e-2.
#
# Step 1 in f32: the same f32 arithmetic in another order (the program's
# masked GRU carry against the reference's valid-prefix loop, the batch
# norms' moments by other reductions): ulps of the terms.
F32 = {'loss_gap': 1e-5,
       # a leaf's gradient over its own norm or the median leaf's: a bias
       # in front of a batch norm has a gradient of round-off alone
       'worst_grad': 1e-3,
       # Adam at the configuration's lr of 1e-3 from the first step (no
       # warm-up) moves each weight by about lr whatever its gradient's
       # size, so an entry whose gradient sits near round-off moves either
       # way, and the steps after carry that on: the gap grows about a
       # hundredfold a step at this size (2e-5 at step 2, 3e-3 at step 3)
       'later_loss_gap': 3e-2,
       'change_gap': 0.3}
# bf16: the program's bf16 GEMMs add in another order than the reference's
# f32 matmul of the rounded operands, and a result on a rounding edge
# lands one bf16 step (2^-8 relative) apart, which the batch norms and the
# GRU carry on; step 1's loss still agrees to 1e-7.
BF16 = {'loss_gap': 1e-5,
        'grad_gap': 1e-2,
        'later_loss_gap': 0.2,
        'change_gap': 0.5}


def _config(bf16):
    with open(os.path.join(spec.BENCH_DIR, 'configs',
                           f'{CONFIG}.json')) as f:
        cfg = json.load(f)
    cfg['model'].update(pc_feat_dim=F)
    cfg['data'].update(num_pc_points=N, max_num_part=P)
    cfg['exp'].update(batch_size=B, bf16=bf16, steps_per_call=2)
    return cfg


def _traffic():
    with open(os.path.join(spec.BENCH_DIR, 'traffic',
                           f'{TRAFFIC}.json')) as f:
        t = json.load(f)
    t['data'].update(n_train=4 * B, n_val=2, part_pool=[2, 3, 4, 5],
                     detail=2)
    t['options'] = {'device_sampling': True}  # 'auto' is on for CUDA only
    return t


def _both(tmp_path, monkeypatch, bf16, seed):
    """(program, reference, initial weights, the run's configuration)
    over the checked steps."""
    monkeypatch.setattr(spec, 'CACHE', str(tmp_path / 'cache'))
    monkeypatch.setenv('MPA_MESH_CACHE_DIR', str(tmp_path / 'mesh'))
    cfg, t = _config(bf16), _traffic()
    trainer, _, cfg_run, p0, prog = harness_cell.build(
        cfg, t, seed, 'cpu', str(tmp_path / 'ckp'))
    harness_cell.free(trainer)
    ref = run_steps(cfg_run, t['wire'], p0, seed, len(prog['loss']),
                    torch.device('cpu'))
    return prog, ref, p0, cfg_run


def _readings(prog, ref, p0, cfg):
    detail = {}
    values = compare.readings(prog, ref, p0, loss_weights(cfg), detail)
    return dict(values, worst_grad=detail['worst_grad'])


@pytest.mark.parametrize('seed', SEEDS)
def test_program_matches_reference_f32(seed, tmp_path, monkeypatch):
    prog, ref, p0, cfg = _both(tmp_path, monkeypatch, False, seed)
    assert len(prog['loss']) == len(ref['loss']) == 3
    assert set(prog['grad']) == set(ref['grad']) == set(p0)
    values = _readings(prog, ref, p0, cfg)
    assert all(values[k] <= lim for k, lim in F32.items()), values


@pytest.mark.parametrize('seed', SEEDS)
def test_program_matches_reference_bf16(seed, tmp_path, monkeypatch):
    prog, ref, p0, cfg = _both(tmp_path, monkeypatch, True, seed)
    values = _readings(prog, ref, p0, cfg)
    assert all(values[k] <= lim for k, lim in BF16.items()), values
    # the rounding points matter: the reference kept in f32 stands ten
    # times and more farther from the program's first gradient
    f32 = run_steps(cfg, 'slot', p0, seed, 3, torch.device('cpu'),
                    precision='f32')
    assert _readings(prog, f32, p0, cfg)['grad_gap'] > \
        10 * values['grad_gap']


def _limits():
    with open(os.path.join(spec.BENCH_DIR, 'workloads',
                           f'{CELL}.json')) as f:
        return json.load(f)['limits']


@pytest.mark.parametrize('fault', [None, _unchanged, _half, _altered],
                         ids=['sound', 'unchanged', 'half', 'altered'])
def test_fault_makes_run_not_correct(fault, tmp_path, monkeypatch):
    """A run of the cell at this size, the program in f32: sound, it comes
    out correct under the cell's limits; with the timed path broken
    underneath (harness tests' faults), not correct."""
    monkeypatch.setattr(spec, 'CACHE', str(tmp_path))
    monkeypatch.setenv('MPA_MESH_CACHE_DIR', str(tmp_path / 'mesh'))
    if fault is not None:
        fault(monkeypatch)
    out = harness_cell.run(_config(False), _traffic(), _limits(), [],
                           2**31 + 5, 0.2, False, device='cpu',
                           log=lambda m: None)
    assert out['correct'] is (fault is None), out['checks']
    assert out['failed'] == 0 and out['attempted'] > 0


@pytest.mark.parametrize('seed', [3, 2**31 + 11])
def test_fp8_control_is_not_correct(seed, tmp_path, monkeypatch):
    """The reference in fp8 in the program's place, against the reference
    in bf16, over a slot cell's nine checked steps."""
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.utils.config_utils import CfgNode
    monkeypatch.setattr(spec, 'CACHE', str(tmp_path))
    t = _traffic()
    steps = harness_cell.check_steps(8)
    t['data']['n_train'] = steps * B
    cfg = spec.run_config(_config(True), t, spec.ensure_data(t), seed)
    shapes = [(n, tuple(p.shape)) for n, p in
              build_model(CfgNode(cfg), 'cpu').named_parameters()]
    p0 = make_weights(shapes, seed, torch.device('cpu'))
    ref = run_steps(cfg, 'slot', p0, seed, steps, torch.device('cpu'))
    ctl = run_steps(cfg, 'slot', p0, seed, steps, torch.device('cpu'),
                    precision='fp8')
    correct, checks = compare.judge(
        compare.readings(ctl, ref, p0, loss_weights(cfg)), _limits())
    assert not correct, checks


def test_model_flops_match_flop_counter():
    """All parts valid: the program's forward and backward of one train
    step's model run exactly the matmuls `model_flops` counts."""
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.utils.config_utils import CfgNode
    cfg = _config(False)
    model = build_model(CfgNode(cfg), 'cpu').train()
    g = torch.Generator().manual_seed(0)
    batch = {'part_pcs': torch.randn(B, P, N, 3, generator=g),
             'part_valids': torch.ones(B, P),
             'valid_matrix': torch.ones(B, P, P),
             'part_label': torch.zeros(B, P, 0),
             'instance_label': torch.zeros(B, P, 0)}
    with FlopCounterMode(display=False) as counter:
        out = model(batch, g)
        (out['rot'].sum() + out['trans'].sum()).backward()
    assert counter.get_total_flops() == flops.model_flops(cfg, [P] * B)


def test_padded_slots_are_not_counted():
    cfg = _config(False)
    assert flops.model_flops(cfg, [2, 3]) < flops.model_flops(cfg, [5, 5])
    assert flops.model_flops(cfg, [2, 3]) == \
        flops.model_flops(cfg, [2]) + flops.model_flops(cfg, [3])


def test_three_chamfers_a_step():
    with open(os.path.join(spec.BENCH_DIR, 'configs',
                           f'{CONFIG}.json')) as f:
        cfg = json.load(f)
    assert family(cfg).iterations(cfg) == 3
    assert flops.chamfer_calls(cfg) == 3
    assert flops.chamfer_pairs(cfg, [2]) == \
        3 * ((2 * 1000) ** 2 + 2 * 1000 * 1000)


@pytest.mark.parametrize('key,value,reason', [
    (('model', 'encoder'), 'dgcnn', 'PointNet'),
    (('model', 'rot_type'), 'rmat', 'quaternion'),
    (('model', 'merge_node'), True, 'merge_node'),
    (('loss', 'noise_dim'), 32, 'noise_dim')])
def test_unsupported_options_raise(key, value, reason):
    cfg = _config(False)
    cfg[key[0]][key[1]] = value
    with pytest.raises(ValueError, match=reason):
        family(cfg).supported(cfg)


def test_reference_imports_neither_jax_nor_the_program():
    import ast
    path = os.path.join(spec.BENCH_DIR, 'reference', 'families',
                        'rgl_net.py')
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or '' for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)]
    assert not [n for n in names if 'jax' in n or 'multi_part_assembly'
                in n or 'flax' in n], names
