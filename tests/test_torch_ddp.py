"""The port's data parallelism (parallel/dist.py) on the CPU: two gloo
ranks, spawned as subprocesses (tests/torch_ddp_worker.py), each on half
of a global batch, against one process on the whole batch and against the
JAX package.

  - the loader's index batches are JAX's `DataLoader` batches, sharded, for
    1, 2 and 3 ranks over two epochs (no process group needed: rank and
    world are arguments);
  - `all_reduce_sum` forward and backward, exactly;
  - sync MaskedBatchNorm (masked, unmasked, lean masked, lean unmasked) on
    2 ranks equals one process on the whole batch: outputs, input and
    weight gradients, running statistics (atol 1e-6, rtol 1e-5);
  - per-replica MaskedBatchNorm equals JAX's under `set_bn_groups(2)` on
    the whole batch, the same tolerances;
  - DGCNN, sync, equals one process on the whole batch (outputs, input
    gradients atol 1e-5; parameter gradients 1e-5 relative L2); its
    EdgeConv stage stays sync under per-replica mode, with JAX's warning;
  - one flagship train step (f32, no dropout, the trainer's
    `optimize_step`) on 2 ranks equals the port's one-process step and the
    JAX step on the global batch: loss 1e-6 relative, gradients and
    updated parameters 1e-5 relative L2 (tests/torch_family_parity.py's
    rule: per parameter, with a floor of 1e-6 of the whole norm; an element
    whose gradient is float noise only within Adam's step bound); both
    ranks' parameters bitwise equal after Adam;
  - rank 0's generator is the one-rank stream; rank 1's differs;
  - both ranks save asynchronously (rank 0 writes): the save returns before
    the write, and after `wait_until_finished` each rank reads the whole
    checkpoint, bitwise the state at the save.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_family_parity as U
from multi_part_assembly_tpu.datasets.loader import DataLoader as JaxLoader
from multi_part_assembly_tpu.models import build_model as jax_build_model
from multi_part_assembly_tpu.models.modules import norm as JN
from multi_part_assembly_tpu.train.state import \
    build_optimizer as jax_build_optimizer
from multi_part_assembly_tpu.utils import config_utils as JCFG
from multi_part_assembly_tpu_torch.datasets import DataLoader
from multi_part_assembly_tpu_torch.models import sync_bn_of
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.models.modules import encoders as TE
from multi_part_assembly_tpu_torch.models.modules.norm import \
    MaskedBatchNorm
from multi_part_assembly_tpu_torch.parallel import dist
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG
from torch_ddp_worker import spawn_ranks

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = ('configs/pn_transformer/pn_transformer/'
            'pn_transformer-32x1-cosine_400e-everyday.py')
OPTS = U.NARROW['pn_transformer'] + [
    'data.max_num_part', str(U.P), 'data.num_pc_points', str(U.N),
    'optimizer.warmup_ratio', '0.0']
COUNTS = (2, 6, 4, 3)  # the global batch: 2 shapes a rank
BN_CASES = {'masked': (False, True), 'unmasked': (False, False),
            'lean_masked': (True, True), 'lean_unmasked': (True, False)}
ATOL, RTOL = 1e-6, 1e-5
SEED = 0


# ---------------------------------------------------------------------------
# the loader's order and shards against JAX's
# ---------------------------------------------------------------------------


class _Indices:
    """A dataset whose items are their indices, for both loaders."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'i': np.int64(i)}

    def set_epoch(self, epoch):
        pass

    def collate_batch(self, indices):
        return {'i': np.asarray(indices, np.int64)}


@pytest.mark.parametrize('world', [1, 2, 3])
@pytest.mark.parametrize('split', ['train', 'val'])
def test_loader_order_matches_jax(world, split):
    """Rank r's batches of each epoch are JAX's `DataLoader` batches with
    `_shard_id` r of `_num_shards` world (JAX loader.py:73-85)."""
    kw = dict(batch_size=4, shuffle=True, drop_last=True, seed=3) \
        if split == 'train' else \
        dict(batch_size=8, shuffle=False, drop_last=False, seed=3)
    ds = _Indices(23)
    for r in range(world):
        ours = DataLoader(ds, rank=r, world=world, **kw)
        ref = JaxLoader(ds, num_workers=1, **kw)
        ref._shard_id, ref._num_shards = r, world
        assert len(ours) == len(ref)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            np.testing.assert_array_equal(ours._indices(), ref._indices())
            got = [b['i'].tolist() for b in ours]
            want = [b['i'].tolist() for b in ref]
            assert got == want and len(got) == len(ours), (r, epoch)


def test_loader_takes_the_process_group_by_default():
    """Without a process group a loader is rank 0 of 1, and its order is
    JAX's: default_rng(seed + epoch).shuffle(arange(n))."""
    loader = DataLoader(_Indices(10), batch_size=10, shuffle=True, seed=0)
    assert (loader.rank, loader.world) == (0, 1) == (dist.rank(),
                                                     dist.world())
    loader.set_epoch(1)
    assert loader._indices().tolist() == [8, 4, 7, 0, 1, 2, 5, 9, 6, 3]


# ---------------------------------------------------------------------------
# the two-rank run
# ---------------------------------------------------------------------------


def _bn_inputs():
    rng = np.random.RandomState(1)
    out = {}
    B, P, N, C = 4, 3, 5, 6
    valids = (np.arange(P)[None] < np.asarray([1, 3, 2, 0])[:, None])
    for name, (lean, masked) in BN_CASES.items():
        out[name] = {
            'lean': lean,
            'x': torch.tensor(rng.randn(B, P, N, C).astype(np.float32) * 2
                              + 0.5),
            'mask': torch.tensor(valids[..., None].astype(np.float32))
            if masked else None,
            'g': torch.tensor(rng.randn(B, P, N, C).astype(np.float32)),
            'weight': torch.tensor(1 + 0.3 * rng.randn(C),
                                   dtype=torch.float32),
            'bias': torch.tensor(0.2 * rng.randn(C), dtype=torch.float32),
            'running_mean': torch.tensor(0.1 * rng.randn(C),
                                         dtype=torch.float32),
            'running_var': torch.tensor(1 + 0.2 * rng.rand(C),
                                        dtype=torch.float32)}
    return out


def _dgcnn_inputs():
    torch.manual_seed(4)
    net = TE.DGCNN(16, k=4)
    rng = np.random.RandomState(2)
    return {'feat': 16, 'k': 4, 'state': net.state_dict(),
            'x': torch.tensor(rng.randn(4, 24, 3).astype(np.float32)),
            'mask': torch.tensor([1.0, 1.0, 0.0, 1.0]),
            'g': torch.tensor(rng.randn(4, 16).astype(np.float32))}


def _flagship_cfgs():
    path = os.path.join(ROOT, FLAGSHIP)
    jcfg = JCFG.load_cfg_file(path).merge_from_list(OPTS)
    tcfg = TCFG.load_cfg_file(path).merge_from_list(OPTS)
    tcfg.exp.bf16 = False
    return jcfg, tcfg


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Inputs written, both ranks run, their results loaded: (inputs,
    [rank 0's, rank 1's], the flagship's JAX (model, variables, batch))."""
    tmp = tmp_path_factory.mktemp('ddp')
    jcfg, _ = _flagship_cfgs()
    data = U.batch(SEED, counts=COUNTS)
    with U.jax_f32_no_dropout():
        model = jax_build_model(jcfg)
        var = U.jax_init(model, U.to_jax(data), train=False)
    inputs = {
        'seed': SEED, 'bn': _bn_inputs(), 'dgcnn': _dgcnn_inputs(),
        'step': {'cfg': FLAGSHIP, 'opts': OPTS, 'data': U.to_torch(data),
                 'state': jax_to_state_dict(var)},
        'ckpt': str(tmp / 'ckpt')}
    path = tmp / 'inputs.pt'
    torch.save(inputs, path)
    worker = os.path.join(ROOT, 'tests', 'torch_ddp_worker.py')
    spawn_ranks(lambda r: [worker, '--inputs', str(path), '--out',
                           str(tmp / f'rank{r}.pt')], timeout=240)
    return inputs, [torch.load(tmp / f'rank{r}.pt', weights_only=False)
                    for r in range(2)], (model, var, data)


def _cat(results, key, field):
    return torch.cat([res[key][field] for res in results])


def test_two_ranks_joined(run):
    _, results, _ = run
    assert [(r['rank'], r['world'], r['device']) for r in results] == \
        [(0, 2, 'cpu'), (1, 2, 'cpu')]


def test_all_reduce_sum_autograd(run):
    """y = sum_r (r + 2) x; loss_r = (r + 1) sum(y): y = 5x on both ranks,
    and x's gradient on rank r is (r + 2)(1 + 2)."""
    _, results, _ = run
    x = torch.arange(4.0)
    for r, res in enumerate(results):
        assert torch.equal(res['allreduce']['y'], 5 * x)
        assert torch.equal(res['allreduce']['dx'],
                           torch.full((4, ), 3.0 * (r + 2)))


def _whole_batch_bn(spec):
    bn = MaskedBatchNorm(spec['x'].shape[-1], lean=spec['lean'])
    with torch.no_grad():
        for name in ('weight', 'bias', 'running_mean', 'running_var'):
            getattr(bn, name).copy_(spec[name])
    bn.train()
    x = spec['x'].clone().requires_grad_(True)
    out = bn(x, spec['mask'])
    (out * spec['g']).sum().backward()
    return {'out': out.detach(), 'dx': x.grad, 'dweight': bn.weight.grad,
            'dbias': bn.bias.grad, 'running_mean': bn.running_mean,
            'running_var': bn.running_var}


def _close(got, want, name, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=name)


def _assert_bn_matches(results, key, ref):
    for field in ('out', 'dx'):
        _close(_cat(results, key, field), ref[field], f'{key} {field}')
    for res in results:
        for field in ('dweight', 'dbias', 'running_mean', 'running_var'):
            _close(res[key][field], ref[field], f'{key} {field}')
    for field in ('running_mean', 'running_var'):
        assert torch.equal(results[0][key][field], results[1][key][field])


@pytest.mark.parametrize('case', list(BN_CASES))
def test_sync_bn_matches_whole_batch(run, case):
    inputs, results, _ = run
    _assert_bn_matches(results, f'bn/{case}/sync',
                       _whole_batch_bn(inputs['bn'][case]))


def _jax_grouped_bn(spec, groups):
    """JAX MaskedBatchNorm on the whole batch under set_bn_groups(groups):
    output, the cotangent's input and parameter gradients, new stats."""
    bn = JN.MaskedBatchNorm()
    stats = {'mean': jnp.asarray(spec['running_mean'].numpy()),
             'var': jnp.asarray(spec['running_var'].numpy())}
    mask = None if spec['mask'] is None else jnp.asarray(
        spec['mask'].numpy())

    def f(x, scale, bias):
        return bn.apply({'params': {'scale': scale, 'bias': bias},
                         'batch_stats': stats}, x, mask, train=True,
                        mutable=['batch_stats'])

    JN.set_bn_groups(groups)
    try:
        out, vjp, mut = jax.vjp(
            f, jnp.asarray(spec['x'].numpy()),
            jnp.asarray(spec['weight'].numpy()),
            jnp.asarray(spec['bias'].numpy()), has_aux=True)
    finally:
        JN.set_bn_groups(1)
    dx, dscale, dbias = vjp(jnp.asarray(spec['g'].numpy()))
    return {'out': out, 'dx': dx, 'dweight': dscale, 'dbias': dbias,
            'running_mean': mut['batch_stats']['mean'],
            'running_var': mut['batch_stats']['var']}


@pytest.mark.parametrize('case', list(BN_CASES))
def test_per_replica_bn_matches_jax_groups(run, case):
    inputs, results, _ = run
    _assert_bn_matches(results, f'bn/{case}/replica',
                       _jax_grouped_bn(inputs['bn'][case], 2))


def test_dgcnn_sync_matches_whole_batch(run):
    inputs, results, _ = run
    d = inputs['dgcnn']
    net = TE.DGCNN(d['feat'], k=d['k'])
    net.load_state_dict(d['state'])
    net.train()
    x = d['x'].clone().requires_grad_(True)
    out = net(x, d['mask'])
    (out * d['g']).sum().backward()
    _close(_cat(results, 'dgcnn', 'out'), out.detach(), 'out', atol=1e-5)
    _close(_cat(results, 'dgcnn', 'dx'), x.grad, 'dx', atol=1e-5)
    grads = {n: q.grad for n, q in net.named_parameters()}
    floor = 1e-6 * float(torch.cat([g.reshape(-1)
                                    for g in grads.values()]).norm())
    for res in results:
        for n, g in grads.items():
            err = float((res['dgcnn']['grads'][n] - g).norm())
            assert err <= 1e-5 * float(g.norm()) + floor, n
        for n, b in net.named_buffers():
            _close(res['dgcnn']['state'][n], b, n)


def test_dgcnn_stage_stays_sync_per_replica(run):
    """Per-replica mode: the EdgeConv stage's injected statistics are
    still global (JAX norm.py:79-86), with JAX's warning."""
    inputs, results, _ = run
    d = inputs['dgcnn']
    net = TE.DGCNN(d['feat'], k=d['k'])
    net.load_state_dict(d['state'])
    net.train()
    out = net._edge_stage(d['x'], net.conv1[0].weight[:, :, 0, 0], net.bn1,
                          d['mask'][:, None, None])
    _close(_cat(results, 'dgcnn_stage', 'out'), out.detach(), 'out',
           atol=1e-5)
    for res in results:
        assert res['dgcnn_stage']['warned']
        _close(res['dgcnn_stage']['running_mean'], net.bn1.running_mean,
               'running_mean')
        _close(res['dgcnn_stage']['running_var'], net.bn1.running_var,
               'running_var')


@pytest.fixture(scope='module')
def references(run):
    """The one-process port step and the JAX step on the global batch, each
    with Adam's update: (port, JAX), as port state_dict names."""
    inputs, _, (model, var, data) = run
    jcfg, tcfg = _flagship_cfgs()
    with U.jax_f32_no_dropout():
        ref = U.jax_mon_step(model, var, data, jcfg)
    tx, _ = jax_build_optimizer(jcfg, 1, var['params'])
    new_params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(
        var['params'], tx.update(ref['grads'], tx.init(var['params']),
                                 var['params'])[0]))
    stats = var.get('batch_stats', {})
    jax_ref = {
        'loss': ref['loss'],
        'grads': jax_to_state_dict({'params': ref['grads'],
                                    'batch_stats': stats}),
        'params': jax_to_state_dict({'params': new_params,
                                     'batch_stats': stats})}

    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.train.state import build_optimizer
    net = U.torch_no_dropout(build_model(tcfg, 'cpu'))
    net.load_state_dict(inputs['step']['state'])
    one = U.torch_mon_step(net, data, tcfg)
    opt, schedule = build_optimizer(tcfg, 1, net)
    for group in opt.param_groups:
        group['lr'] = schedule(0)
    for n, q in net.named_parameters():
        q.grad = one['grads'][n].clone()
    opt.step()
    port = {'loss': one['loss'], 'grads': one['grads'],
            'params': {n: q.detach().clone()
                       for n, q in net.named_parameters()}}
    return port, jax_ref


def _assert_within(ours, ref, tol, what):
    """Every tensor within `tol` relative L2 of the reference's, with a
    floor of 1e-6 of the whole reference's norm."""
    floor = 1e-6 * float(np.linalg.norm(np.concatenate(
        [np.asarray(ref[n]).ravel() for n in ours])))
    for n, v in ours.items():
        err = float(np.linalg.norm(np.asarray(v) - np.asarray(ref[n])))
        assert err <= tol * float(np.linalg.norm(np.asarray(ref[n]))) + \
            floor, f'{what} {n}: rel. L2 {U.rel_l2(v, ref[n]):.2e}'


@pytest.mark.parametrize('against', ['port', 'jax'])
def test_ddp_step_matches_global_batch(run, references, against):
    """One flagship step on 2 ranks x 2 shapes against one process (the
    port's, JAX's) on the 4 shapes.  Adam's first step moves an element by
    lr g / (|g| + 1e-8), which turns float noise in a gradient near zero
    (the attention's key bias has an exactly zero true gradient) into a
    step of up to lr: as in tests/test_torch_train_step.py, elements whose
    reference gradient is below 1e-6 are only held to |step| <= lr."""
    inputs, results, _ = run
    ref = references[0 if against == 'port' else 1]
    before = inputs['step']['state']
    lr = 1e-3
    signal = {n: np.abs(np.asarray(g)) > 1e-6
              for n, g in ref['grads'].items()}
    for res in results:
        step = res['step']
        assert abs(step['logs']['loss'] - ref['loss']) <= \
            1e-6 * abs(ref['loss'])
        _assert_within(step['grads'], ref['grads'], 1e-5, 'gradient')
        _assert_within({n: np.asarray(v)[signal[n]]
                        for n, v in step['params'].items()},
                       {n: np.asarray(v)[signal[n]]
                        for n, v in ref['params'].items()}, 1e-5,
                       'parameter')
        for n, v in step['params'].items():
            moved = np.abs(np.asarray(v) - np.asarray(before[n]))
            assert moved[~signal[n]].max(initial=0) <= lr + 1e-9, n


def test_ddp_step_ranks_bitwise_equal(run):
    """After the averaged gradients and Adam every rank holds the same
    parameters and running statistics, bit for bit."""
    _, results, _ = run
    a, b = results[0]['step'], results[1]['step']
    assert a['logs'] == b['logs']
    for key in ('grads', 'params', 'state'):
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)


def test_rank_generators(run):
    """Rank 0 keeps the one-rank stream (seed itself); rank 1's differs."""
    _, results, _ = run
    one_rank = torch.randn(8, generator=torch.Generator().manual_seed(SEED))
    assert torch.equal(results[0]['draws'], one_rank)
    assert not torch.equal(results[1]['draws'], one_rank)
    assert dist.rank_seed(SEED) == dist.rank_seed(SEED, 0) == SEED
    assert len({dist.rank_seed(SEED, r) for r in range(8)}) == 8


@pytest.mark.parametrize('value,want', [
    (True, True), (False, False), ('False', False), ('true', True)])
def test_sync_bn_of_reads_words(value, want):
    cfg = TCFG.CfgNode({'exp': TCFG.CfgNode({'sync_bn': value})})
    assert sync_bn_of(cfg) is want
    model_cfg = TCFG.load_cfg_file(os.path.join(ROOT, FLAGSHIP))
    assert sync_bn_of(model_cfg) is True  # the default
    with pytest.raises(ValueError, match='sync_bn'):
        sync_bn_of(TCFG.CfgNode({'exp': TCFG.CfgNode({'sync_bn': 'maybe'})}))


def test_async_save_is_whole_for_every_rank(run):
    _, results, _ = run
    for r, res in enumerate(results):
        ck = res['ckpt']
        assert not ck['on_disk_at_return'], r  # the write was held back
        assert ck['steps'] == [0], r
        assert ck['writes'] == (1 if r == 0 else 0), r
        assert set(ck['loaded']) == set(ck['at_save']), r
        for k, v in ck['at_save'].items():
            assert torch.equal(ck['loaded'][k], v), (r, k)
    # both ranks held the same weights at the save
    for k, v in results[0]['ckpt']['at_save'].items():
        assert torch.equal(results[1]['ckpt']['at_save'][k], v), k
