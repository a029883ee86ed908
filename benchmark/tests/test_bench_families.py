"""Reference families found by the configuration's `model.name`.

The three cells of the PN-Transformer read what they read before the
lookup: `run_steps` at test sizes gives bitwise the losses, first
gradients and weights pinned in `pinned_steps.json`, and the step's FLOPs
and the chamfer's least time at the cells' own sizes are the pinned
numbers.  The pins were recorded by `record` on the tree before the lookup
and are not regenerated.  A stand-in family, registered in `sys.modules`
with no file in the tree, stacks the PN-Transformer's poses three times,
as a family that supervises each of three rounds does: its loss terms,
its chamfer work and its semantic match draws read three times the
PN-Transformer's.  A name with no module raises and names the file to add.
"""

import copy
import hashlib
import inspect
import json
import os
import sys
import types

import pytest
import torch

from benchmark.harness import cell as harness_cell
from benchmark.harness import flops, spec
from benchmark.harness.weights import make_weights
from benchmark.reference import data as D
from benchmark.reference import loss as L
from benchmark.reference import model as M
from benchmark.reference import train as T
from benchmark.tests import tiny

PINNED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'pinned_steps.json')
PINNED_CELLS = ('flagship-everyday-slot', 'semantic-chair-slot',
                'flagship-everyday-host')
SEED = 2**31 + 7
STEPS = 3
# part counts of a batch, for the FLOP and chamfer pins at the cells' sizes
COUNTS = [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 10, 12, 16, 20] * 2
STANDIN = 'stacked3'
ITERATIONS = 3


def _digest(t):
    t = t.detach().cpu().contiguous()
    return f'{t.dtype} {tuple(t.shape)} ' + hashlib.sha256(
        t.numpy().tobytes()).hexdigest()


class _OneThread:
    """torch on one thread: the CPU's reductions then add in one order."""

    def __enter__(self):
        self.threads = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.threads)


def _setup(cell, cache):
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.utils.config_utils import CfgNode
    config, traffic = tiny.CELLS[cell]
    t = tiny.traffic(traffic)
    cfg = spec.run_config(tiny.config(config), t,
                          spec.ensure_data(t, str(cache)), SEED)
    shapes = [(n, tuple(p.shape)) for n, p in
              build_model(CfgNode(cfg), 'cpu').named_parameters()]
    return cfg, t['wire'], make_weights(shapes, SEED, torch.device('cpu'))


def _full_config(cell):
    config, traffic = tiny.CELLS[cell]
    with open(os.path.join(spec.BENCH_DIR, 'traffic',
                           f'{traffic}.json')) as f:
        t = json.load(f)
    with open(os.path.join(spec.BENCH_DIR, 'configs', f'{config}.json')) as f:
        return spec.run_config(json.load(f), t, 'unused', SEED)


class _Trace:
    """What chamfer_roofline reads of a trace: a span and the chamfer
    kernels' seconds."""
    span = (0, 1)

    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_seconds(self, pattern):
        return self.seconds


def _readers(cfg):
    rec = {'cfg': cfg,
           'window': {'seconds': 10.0, 'batch_counts': [COUNTS] * 3},
           'trace': {'trace': _Trace(0.25), 'batch_counts': [COUNTS] * 2}}
    return {name: harness_cell.load_reader(name)(rec)
            for name in ('chamfer_roofline', 'step_mfu_pct')}


def record(cell, cache):
    """The pinned numbers of a cell: `run_steps` at test sizes on one
    thread (losses, first gradient, weights after the steps, exactly), and
    at the cell's sizes the step's FLOPs, chamfer pairs and what
    chamfer_roofline and step_mfu_pct read of a fixed record."""
    cfg, wire, p0 = _setup(cell, cache)
    with _OneThread():
        out = T.run_steps(cfg, wire, p0, SEED, STEPS, torch.device('cpu'))
    full = _full_config(cell)
    return {
        'loss': [{k: float.hex(v) for k, v in s.items()}
                 for s in out['loss']],
        'grad': {n: _digest(g) for n, g in out['grad'].items()},
        'params': {n: _digest(p) for n, p in out['params'].items()},
        'step_flops': flops.step_flops(full, COUNTS),
        'chamfer_pairs': flops.chamfer_pairs(full, COUNTS),
        'readers': {k: float.hex(v) for k, v in _readers(full).items()},
    }


@pytest.mark.parametrize('cell', PINNED_CELLS)
def test_cells_read_as_pinned(cell, tmp_path):
    with open(PINNED) as f:
        pinned = json.load(f)[cell]
    assert record(cell, tmp_path) == pinned


# -- the stand-in family ------------------------------------------------------

class _Stacked:
    """The PN-Transformer's poses stacked ITERATIONS times: [T, B, P, .]."""

    def __init__(self, inner):
        self.inner = inner

    def precompute(self, batch):
        return self.inner.precompute(batch)

    def sample(self, feats, generator):
        q, t = self.inner.sample(feats, generator)
        return (torch.stack([q] * ITERATIONS),
                torch.stack([t] * ITERATIONS))


@pytest.fixture
def standin(monkeypatch):
    """A family module `stacked3` in `sys.modules` only: every function of
    the contract, the PN-Transformer's model under it."""
    from benchmark.reference.families import pn_transformer as pn
    mod = types.ModuleType(f'benchmark.reference.families.{STANDIN}')
    mod.supported = lambda cfg: pn.supported(cfg)
    mod.build = lambda params, cfg, prec: _Stacked(pn.build(params, cfg,
                                                            prec))
    mod.iterations = lambda cfg: ITERATIONS
    mod.model_flops = lambda cfg, counts: 7 * sum(counts)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def _as(cfg, name):
    cfg = copy.deepcopy(cfg)
    cfg['model']['name'] = name
    return cfg


def _batch(cfg):
    """The first batch of epoch 0 of a test-sized cell, augmented where the
    data is geometric."""
    batches = T.Batches(cfg, 'slot', SEED, torch.device('cpu'))
    batch = batches(0)
    if not batches.semantic:
        batch = D.augment(batch, torch.Generator().manual_seed(1))
    return batch


def _loss(cfg, p0, batch, seed=5, log=None):
    from benchmark.reference.families import family
    fam = family(cfg)
    model = fam.build(p0, cfg, M.Precision('f32'))
    if log is not None:
        sample = model.sample

        def logged(feats, generator):
            log.append('sample')
            return sample(feats, generator)
        model.sample = logged
    torch.manual_seed(seed)
    return L.mon_loss(model, batch, cfg, torch.Generator().manual_seed(seed))


def test_geometric_terms_sum_over_iterations(standin, tmp_path):
    cfg, _, p0 = _setup('flagship-everyday-slot', tmp_path)
    batch = _batch(cfg)
    with _OneThread():
        _, one = _loss(cfg, p0, batch)
        _, three = _loss(_as(cfg, STANDIN), p0, batch)
    assert set(one) == set(three) == set(L.loss_weights(cfg)) | {'loss'}
    for k in one:
        assert float(three[k]) == pytest.approx(ITERATIONS * float(one[k]),
                                                rel=1e-6, abs=0), k


def test_semantic_draws_a_subsample_each_iteration(standin, tmp_path,
                                                   monkeypatch):
    cfg, _, p0 = _setup('semantic-chair-slot', tmp_path)
    batch = _batch(cfg)
    log = []
    match = L.match

    def logged(*args):
        log.append('match')
        return match(*args)
    monkeypatch.setattr(L, 'match', logged)
    S = int(cfg['loss']['sample_iter'])
    _loss(cfg, p0, batch, log=log)
    assert log == ['sample', 'match'] * S
    log.clear()
    _loss(_as(cfg, STANDIN), p0, batch, log=log)
    assert log == (['sample'] + ['match'] * ITERATIONS) * S


def test_semantic_iterations_draw_in_the_ports_order(standin, tmp_path,
                                                     monkeypatch):
    """Each iteration's subsample is the next draw of the generator after
    the sample's noise: the stand-in's first iteration of each sample sees
    the subsample that the T = 1 family's sample draws, given the same
    generator state before the sample."""
    cfg, _, p0 = _setup('semantic-chair-slot', tmp_path)
    batch = _batch(cfg)
    seen = []
    match = L.match

    def logged(pcs, q, t, gq, gt, ids, idx):
        seen.append(idx.clone())
        return match(pcs, q, t, gq, gt, ids, idx)
    monkeypatch.setattr(L, 'match', logged)
    N = batch['part_pcs'].shape[2]
    cfg3 = _as(cfg, STANDIN)
    cfg3['loss']['sample_iter'] = 1
    _loss(cfg3, p0, batch, seed=9)
    g = torch.Generator().manual_seed(9)
    torch.randn((batch['part_valids'].shape + (int(cfg['loss']['noise_dim']),
                                               )), generator=g)
    want = [torch.randperm(N, generator=g)[:100] for _ in range(ITERATIONS)]
    assert len(seen) == ITERATIONS
    assert all(torch.equal(a, b) for a, b in zip(seen, want))


def test_chamfer_work_counts_iterations(standin):
    for cell in ('flagship-everyday-slot', 'semantic-chair-slot'):
        cfg = _full_config(cell)
        cfg3 = _as(cfg, STANDIN)
        assert flops.chamfer_pairs(cfg3, COUNTS) == \
            ITERATIONS * flops.chamfer_pairs(cfg, COUNTS)
        assert _readers(cfg3)['chamfer_roofline'] == pytest.approx(
            ITERATIONS * _readers(cfg)['chamfer_roofline'], rel=1e-12)


def test_model_flops_are_the_familys(standin):
    cfg3 = _as(_full_config('flagship-everyday-slot'), STANDIN)
    assert flops.model_flops(cfg3, COUNTS) == 7 * sum(COUNTS)
    assert flops.step_flops(cfg3, COUNTS) == 7 * sum(COUNTS) + \
        flops.CHAMFER_FLOPS * flops.chamfer_pairs(cfg3, COUNTS)


def test_a_standin_family_trains_through_run_steps(standin, tmp_path):
    """A family joins with its module alone: the stand-in's first steps
    run, and its step-1 loss is three times the PN-Transformer's."""
    cfg, wire, p0 = _setup('flagship-everyday-host', tmp_path)
    with _OneThread():
        one = T.run_steps(cfg, wire, p0, SEED, 1, torch.device('cpu'))
        three = T.run_steps(_as(cfg, STANDIN), wire, p0, SEED, 1,
                            torch.device('cpu'))
    assert three['loss'][0]['loss'] == pytest.approx(
        ITERATIONS * one['loss'][0]['loss'], rel=1e-6)
    assert set(three['grad']) == set(p0)


def test_unsupported_options_raise(standin, tmp_path):
    cfg, wire, p0 = _setup('flagship-everyday-host', tmp_path)
    cfg = _as(cfg, STANDIN)
    cfg['model']['rot_type'] = 'rmat'
    with pytest.raises(ValueError, match='quaternion'):
        T.run_steps(cfg, wire, p0, SEED, 1, torch.device('cpu'))


def test_a_missing_family_names_its_file(tmp_path):
    cfg, wire, p0 = _setup('flagship-everyday-host', tmp_path)
    with pytest.raises(ValueError,
                       match='benchmark/reference/families/no_such_net.py'):
        T.run_steps(_as(cfg, 'no_such_net'), wire, p0, SEED, 1,
                    torch.device('cpu'))


def test_run_steps_names_no_model():
    src = inspect.getsource(T.run_steps)
    families = os.path.join(spec.BENCH_DIR, 'reference', 'families')
    names = [f[:-3] for f in os.listdir(families)
             if f.endswith('.py') and f != '__init__.py']
    assert names
    for name in names + ['PNTransformer', 'transformer']:
        assert name not in src, name
