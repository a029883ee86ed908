"""The port's tracer (utils/tracing.py) on the CPU: spans kept only under a
profiler (set-up and first mesh parses always), their names, threads,
parents and (epoch, batch) ids, each span's `record_function` twin within
0.05 ms of it, the counters, the kernels' launcher (`launch.<key>` and
its error, on a fake library), the record's bound; the region marks, which
launch nothing on a CPU tensor (a step's numbers are bitwise those of
unmarked code, and its autograd graph holds no mark node), nest in the
step's order when their launches are recorded in place of the card's.
RGL-Net's graph layers (`relation`, `edge_mlp`, `gru`, `node_mlp`) and the
counters `gnn.pair_rows`, `gru.steps`, `data.valid_pairs` on a small batch.
The marks on the card: tests/test_torch_cuda.py."""

import contextlib
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from multi_part_assembly_tpu_torch.train import step as TSTEP
from multi_part_assembly_tpu_torch.train.trainer import Trainer
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG
from multi_part_assembly_tpu_torch.utils import tracing

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'scripts'))
CONFIGS = os.path.join(ROOT, 'configs/pn_transformer/pn_transformer')
FLAGSHIP = os.path.join(CONFIGS, 'pn_transformer-32x1-cosine_400e-everyday.py')
CHAIR = os.path.join(CONFIGS,
                     'pn_transformer-32x1-cosine_400e-partnet_chair.py')
RGL = os.path.join(ROOT, 'configs/rgl_net/rgl_net-32x1-cosine_200e-everyday.py')
RGL_TINY = ['model.pc_feat_dim', '16', 'data.max_num_part', '6',
            'data.num_pc_points', '32', 'exp.batch_size', '2',
            'exp.bf16', 'False', 'exp.num_epochs', '3', 'exp.val_every', '1',
            'exp.val_sample_vis', '0']
TINY = ['model.pc_feat_dim', '16', 'model.transformer_feat_dim', '32',
        'model.transformer_heads', '4', 'model.transformer_layers', '2',
        'data.max_num_part', '6', 'data.num_pc_points', '32',
        'exp.batch_size', '2', 'exp.bf16', 'False', 'exp.num_epochs', '3',
        'exp.val_every', '1', 'exp.val_sample_vis', '0']


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """A geometric set of 10 shapes (5 steps of batch 2 an epoch) and a
    semantic one of 8 (4 steps)."""
    from make_synthetic_data import generate, generate_partnet
    root = tmp_path_factory.mktemp('tracing')
    os.environ['MPA_MESH_CACHE_DIR'] = str(root / 'mesh_cache')
    return {
        'geometry': generate(str(root / 'bb'), n_shapes=10, min_parts=2,
                             max_parts=5, seed=0),
        'semantic': generate_partnet(str(root / 'partnet'), n_shapes=8,
                                     min_parts=2, max_parts=4,
                                     num_points=32, seed=0,
                                     split_prefix='Chair.')}


def _trainer(data, tmp_path, kind='geometry', *opts):
    """A Trainer on the CPU at a small width: the flagship ('geometry'),
    the semantic PN-Transformer ('semantic') or RGL-Net's everyday config
    ('rgl_net', geometric data)."""
    if kind == 'rgl_net':
        cfg = TCFG.load_cfg_file(RGL).merge_from_list(
            ['data.data_dir', data['geometry'], *RGL_TINY, *opts])
        cfg.freeze()
        return Trainer(cfg, 'cpu', ckp_dir=str(tmp_path / kind),
                       resume=False, quiet=True)
    cfg = TCFG.load_cfg_file(FLAGSHIP if kind == 'geometry' else CHAIR)
    cfg = cfg.merge_from_list(['data.data_dir', data[kind], *TINY, *opts])
    cfg.freeze()
    return Trainer(cfg, 'cpu', ckp_dir=str(tmp_path / kind), resume=False,
                   quiet=True)


def _profiled(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return prof


@pytest.fixture(autouse=True)
def _empty_record():
    tracing.reset()
    yield
    tracing.reset()


# -- spans and counters ------------------------------------------------------

def test_span_off_without_a_profiler_always_and_timed():
    with tracing.span('off', batch=0) as off:
        pass
    with tracing.span('kept', always=True, batch=1) as kept:
        pass
    with tracing.span('timed', timed=True) as timed:
        pass
    assert off.seconds is None and timed.seconds >= 0
    assert [s.name for s in tracing.spans()] == ['kept']
    assert kept.ids == {'batch': 1} and kept.seconds >= 0
    assert not tracing.recording()


def test_spans_under_a_profiler_nest_with_threads_and_ids():
    import threading

    def body():
        assert tracing.recording()
        with tracing.span('outer', epoch=3):
            with tracing.span('inner', epoch=3, batch=0):
                pass
            worker = threading.Thread(target=lambda: tracing.span(
                'other', batch=1).__enter__().__exit__(None, None, None),
                name='side')
            worker.start()
            worker.join()
    _profiled(body)
    got = {s.name: s for s in tracing.spans()}
    assert set(got) == {'outer', 'inner', 'other'}
    assert got['inner'].parent == got['outer'].sid
    assert got['outer'].parent is None and got['other'].parent is None
    assert got['other'].thread == 'side'
    assert got['inner'].ids == {'epoch': 3, 'batch': 0}
    o, i = got['outer'], got['inner']
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns


def _twin_gaps_ns():
    """The largest gap, at either end, between a span and its range."""
    def body():
        for n in range(20):
            with tracing.span(f'twin.{n % 3}', batch=n):
                with tracing.span('twin.inner'):
                    torch.ones(64).sum()
    tracing.reset()
    prof = _profiled(body)
    ranges = [(ev.name(), ev.start_ns(), ev.end_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith('twin.')]
    spans = tracing.spans()
    assert len(spans) == 40 and len(ranges) == 40
    worst = 0
    for s in spans:
        twin = min((r for r in ranges if r[0] == s.name),
                   key=lambda r: abs(r[1] - s.start_ns))
        worst = max(worst, abs(twin[1] - s.start_ns),
                    abs(twin[2] - s.end_ns))
    return worst


def test_record_function_twin_within_50us():
    """Each span opens a torch.profiler range of its name: both on one
    clock (kineto's Unix nanoseconds), within 0.05 ms at each end.  The
    profiler's first use in a process is slow, and a busy host can preempt
    the thread between the two stamps: the least of three traced runs
    after a warm-up counts."""
    _twin_gaps_ns()
    assert min(_twin_gaps_ns() for _ in range(3)) < 50_000


def test_counters_add_and_reset():
    tracing.count('a')
    tracing.count('a', 4)
    tracing.count('b', np.int64(2))
    assert tracing.counters() == {'a': 5, 'b': 2}
    tracing.reset()
    assert tracing.counters() == {} and tracing.spans() == []


def test_counters_lose_no_update_across_threads():
    """Kernels launch from the loader's placement thread and the training
    thread at once: 16 threads counting one counter, switching every
    microsecond, lose no update."""
    tracing.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [tracing.count('launch.stress')
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert tracing.counters().get('launch.stress') == 16 * 2000


def test_launcher_counts_and_raises_naming_the_entry_point(monkeypatch):
    """ops/cuda_build.py `launch` on a fake library, device guard and
    stream: the entry point gets its arguments and the current stream
    inside the device's guard; a zero return counts `launch.<key>` once, a
    non-zero one raises naming the entry point and counts nothing."""
    from multi_part_assembly_tpu_torch.ops import cuda_build
    calls, guards, rcs = [], [], [0, 700]

    class Lib:
        def mpa_fake(self, *args):
            calls.append((args, tuple(guards)))
            return rcs.pop(0)

    @contextlib.contextmanager
    def guard(device):
        guards.append(device)
        yield
        guards.pop()
    lib = Lib()
    monkeypatch.setattr(cuda_build, 'load_library', lambda: lib)
    monkeypatch.setattr(torch.cuda, 'device', guard)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda: types.SimpleNamespace(cuda_stream=77))
    tracing.reset()
    cuda_build.launch('mpa_fake', 'fake', 'cuda:1', 3, 4)
    assert calls == [((3, 4, 77), ('cuda:1', ))] and not guards
    assert tracing.counters().get('launch.fake') == 1
    with pytest.raises(RuntimeError, match='^mpa_fake: CUDA error 700$'):
        cuda_build.launch('mpa_fake', 'fake', 'cuda:1', 5)
    assert calls[1] == ((5, 77), ('cuda:1', )) and not guards
    assert tracing.counters().get('launch.fake') == 1


def test_record_keeps_the_last_max_spans():
    for n in range(tracing.MAX_SPANS + 10):
        with tracing.span('bounded', always=True, n=n):
            pass
    kept = tracing.spans()
    assert len(kept) == tracing.MAX_SPANS
    assert kept[0].ids['n'] == 10 and kept[-1].ids['n'] == \
        tracing.MAX_SPANS + 9


# -- the trainer's spans and counters ----------------------------------------

def _epoch_parts(loader, epoch):
    ds = loader.dataset
    loader.set_epoch(epoch)
    return sum(len(ds._mesh_files(int(i)))
               for idx in loader._batches() for i in idx)


@pytest.mark.parametrize('spc', ['1', '2'])
def test_trainer_spans_and_counters(data, tmp_path, spc):
    trainer = _trainer(data, tmp_path, 'geometry', 'exp.steps_per_call',
                       spc)
    setup = {s.name for s in tracing.spans()}
    assert {'setup.data', 'setup.tables'} <= setup
    trainer.train_epoch(0)  # the host wire's first parses: always kept
    assert {s.name for s in tracing.spans()} - setup <= {'data.mesh_load'}
    assert 'data.mesh_load' in {s.name for s in tracing.spans()}

    tracing.reset()
    trainer.train_epoch(1)  # nothing kept without a profiler
    assert tracing.spans() == []
    c = tracing.counters()
    loader = trainer.train_loader
    B, P = 2, 6
    assert c['data.batches'] == len(loader) == 5
    assert c['data.valid_parts'] == _epoch_parts(loader, 1)
    assert c['step.slots'] == len(loader) * B * P

    tracing.reset()
    _profiled(lambda: trainer.train_epoch(2))
    spans = tracing.spans()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    # the consumer's last wait finds the epoch's end
    for name, thread, n in (('data.collate', 'loader-collate', 5),
                            ('data.place', 'loader-transform', 5),
                            ('data.wait', 'MainThread', 6)):
        assert sorted(s.ids['batch'] for s in by[name]) == list(range(n))
        assert all(s.ids['epoch'] == 2 and s.thread == thread
                   for s in by[name]), name
    gathers = {s.sid for s in by['train.gather']}
    # a group's hand-overs inside its gather; the dispatch after it
    assert all(s.parent in gathers for s in by['data.wait']
               if s.ids['batch'] > 0)
    epoch, = by['train.epoch']
    assert epoch.ids == {'epoch': 2} and epoch.parent is None
    assert all(s.parent == epoch.sid for s in by['train.dispatch'] +
               by['train.gather'] + by['train.flush'])
    opening, = by['data.epoch_start']
    assert opening.parent in gathers
    first = [s for s in by['data.wait'] if s.ids['batch'] == 0][0]
    assert first.parent == opening.sid and opening.ids == {'epoch': 2}
    assert opening.start_ns <= first.start_ns <= first.end_ns <= \
        opening.end_ns
    g = int(spc)
    assert [(s.ids['step'], s.ids['steps']) for s in by['train.dispatch']] \
        == [(11 + i, g) for i in range(0, 5 - 5 % g, g)] + \
        [(11 + i, 1) for i in range(5 - 5 % g, 5)]
    flushes = {s.sid for s in by['train.flush']}
    assert by['train.flush.fetch'] and by['train.flush.write']
    for child in by['train.flush.fetch'] + by['train.flush.write']:
        assert child.parent in flushes
    # the place of a batch follows its collate, and its wait ends after
    for n in range(5):
        col, p, w = (next(s for s in by[k] if s.ids["batch"] == n)
                   for k in ('data.collate', 'data.place', 'data.wait'))
        assert col.end_ns <= p.start_ns and p.end_ns <= w.end_ns
    trainer.close()


class _Paced:
    """A dataset of `n` one-part shapes whose collate sleeps `delay` s."""

    def __init__(self, n, delay):
        self.n, self.delay = n, delay

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass

    def collate_batch(self, indices):
        time.sleep(self.delay)
        return {'part_counts': np.ones(len(indices), np.int64)}


@pytest.mark.parametrize('slow', ['collate', 'consumer'])
def test_starved_counts_hand_overs_that_found_no_batch(slow):
    """`data.starved`: every hand-over waits behind a slow collate (the
    epoch's end may find the last batch still queued); behind a slow
    consumer, the queue is full after the first."""
    from multi_part_assembly_tpu_torch.datasets.geometry import DataLoader
    loader = DataLoader(_Paced(12, 0.05 if slow == 'collate' else 0.0),
                        batch_size=2, rank=0, world=1)
    tracing.reset()
    for _ in loader:
        if slow == 'consumer':
            time.sleep(0.05)
    c = tracing.counters()
    assert c['data.batches'] == 6 and c['data.valid_parts'] == 12
    if slow == 'collate':
        assert c['data.starved'] in (6, 7)
    else:
        assert c.get('data.starved', 0) <= 1


def test_timers_read_their_spans(data, tmp_path):
    """`CheckpointManager.write_seconds` is its `ckpt.write` span's
    reading, on the writer's thread."""
    trainer = _trainer(data, tmp_path)
    trainer.train_epoch(0)
    tracing.reset()
    _profiled(lambda: (trainer.save_checkpoint(0, {'val/part_acc': 0.5}),
                       trainer.ckpt_mgr.wait_until_finished()))
    write, = [s for s in tracing.spans() if s.name == 'ckpt.write']
    assert trainer.ckpt_mgr.write_seconds == [write.seconds]
    assert write.thread == 'checkpoint-writer' and write.ids == {'epoch': 0}
    trainer.close()


# -- region marks ------------------------------------------------------------

def _step(trainer, batch):
    """One eager step of the trainer on a host batch: its log vector."""
    return trainer._step_vector(trainer._device_batch(batch))


def _plain(monkeypatch):
    """Region functions as unmarked code has them: nothing at all."""
    monkeypatch.setattr(tracing, 'region_begin', lambda name, *t: t)
    monkeypatch.setattr(tracing, 'region_end', lambda name, *t: t)
    monkeypatch.setattr(tracing, 'end_backward', lambda: None)

    class _Nothing:
        def __init__(self, name, device):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(tracing, 'region', _Nothing)


def _state(trainer):
    return [t.detach().clone() for t in
            list(trainer.model.parameters()) + list(trainer.model.buffers())]


@pytest.mark.parametrize('kind', ['geometry', 'semantic', 'rgl_net'])
def test_cpu_step_bitwise_unmarked_and_without_mark_nodes(
        data, tmp_path, kind, monkeypatch):
    outs = []
    for plain in (False, True):
        trainer = _trainer(data, tmp_path / str(plain), kind)
        if plain:
            _plain(monkeypatch)
        batch = next(iter(trainer.train_loader))
        values = _step(trainer, batch)
        outs.append((values, _state(trainer)))
        trainer.close()
    (v0, s0), (v1, s1) = outs
    assert torch.equal(v0, v1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))

    monkeypatch.undo()
    trainer = _trainer(data, tmp_path / 'graph', kind)
    from multi_part_assembly_tpu_torch.train.core import mon_loss
    batch = trainer._augment(next(iter(trainer.train_loader)))
    loss, _ = mon_loss(trainer.model, batch, cfg=trainer.cfg, training=True,
                       generator=trainer.generator)
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        assert '_Edge' not in type(node).__name__
        todo += [f for f, _ in node.next_functions]
    assert len(seen) > 50
    trainer.close()


def _launches(monkeypatch):
    """Record the marks' launches on CPU tensors, as if on the card."""
    launched = []
    monkeypatch.setattr(tracing, '_on_card', lambda device: True)
    monkeypatch.setattr(tracing, '_launch',
                        lambda edge, device: launched.append(edge))
    return launched


def _nesting(launched):
    """Each begin closed by its end, innermost first; (region, depth) of
    every region in order of opening."""
    stack, order = [], []
    for edge in launched:
        region, what = edge.rsplit('_', 1)
        if what == 'begin':
            order.append((region, len(stack)))
            stack.append(region)
        else:
            assert stack and stack.pop() == region, (edge, launched)
    assert not stack, launched
    return order


def test_region_marks_nest_in_step_order(data, tmp_path, monkeypatch):
    """The flagship's step (augmentation, PointNet with five masked batch
    norms and its max-pool, transformer, head, loss; backward; clipping and
    Adam): each region's marks once, the backward's in reverse, the
    encoder's backward closed after the backward pass."""
    trainer = _trainer(data, tmp_path)
    batch = next(iter(trainer.train_loader))
    launched = _launches(monkeypatch)
    _step(trainer, batch)
    bn = [('masked_bn', 1)] * 5 + [('max_pool', 1)]
    bn_bwd = [('max_pool_bwd', 1)] + [('masked_bn_bwd', 1)] * 5
    assert _nesting(launched) == [
        ('augment', 0), ('encoder', 0), *bn, ('transformer', 0),
        ('pose_head', 0), ('loss', 0), ('loss_bwd', 0),
        ('pose_head_bwd', 0), ('transformer_bwd', 0), ('encoder_bwd', 0),
        *bn_bwd, ('optimizer', 0)]
    trainer.close()


def test_semantic_region_marks_a_sample_each(data, tmp_path, monkeypatch):
    """MoN with S = 5 samples: a head, a loss, its matching and the LAP's
    cost inside it a sample, forward and backward; no augmentation."""
    trainer = _trainer(data, tmp_path, 'semantic')
    S = int(trainer.cfg.loss.sample_iter)
    assert S == 5
    batch = next(iter(trainer.train_loader))
    launched = _launches(monkeypatch)
    _step(trainer, batch)
    order = _nesting(launched)
    count = {}
    for region, depth in order:
        count[(region, depth)] = count.get((region, depth), 0) + 1
    assert count == {
        ('encoder', 0): 1, ('masked_bn', 1): 5, ('max_pool', 1): 1,
        ('transformer', 0): 1,
        ('pose_head', 0): S, ('loss', 0): S, ('matching', 1): S,
        ('lap_cost', 2): S,
        ('loss_bwd', 0): S, ('pose_head_bwd', 0): S,
        ('transformer_bwd', 0): 1, ('encoder_bwd', 0): 1,
        ('max_pool_bwd', 1): 1, ('masked_bn_bwd', 1): 5,
        ('optimizer', 0): 1}
    assert order[-1] == ('optimizer', 0)
    trainer.close()


def _rgl_regions(T):
    """RGL-Net's step as its marks nest: the encoder (its five batch norms
    and its pool), then T rounds (the
    relation from the second on, the edge MLP and the node MLP with three
    batch norms each, the GRU, the pose head), the loss; the backward in
    the mirror order, the encoder's closed after the backward pass."""
    bn, bn_bwd = [('masked_bn', 1)] * 3, [('masked_bn_bwd', 1)] * 3
    fwd, bwd = [], []
    for it in range(T):
        fwd += ([('relation', 0)] if it else []) + [('edge_mlp', 0), *bn,
                                                    ('gru', 0),
                                                    ('node_mlp', 0), *bn,
                                                    ('pose_head', 0)]
        bwd = [('pose_head_bwd', 0), ('node_mlp_bwd', 0), *bn_bwd,
               ('gru_bwd', 0), ('edge_mlp_bwd', 0), *bn_bwd] + \
            ([('relation_bwd', 0)] if it else []) + bwd
    return ([('augment', 0), ('encoder', 0), *[('masked_bn', 1)] * 5,
             ('max_pool', 1)]
            + fwd + [('loss', 0), ('loss_bwd', 0)] + bwd
            + [('encoder_bwd', 0), ('max_pool_bwd', 1),
               *[('masked_bn_bwd', 1)] * 5, ('optimizer', 0)])


def test_rgl_net_region_marks_nest_in_step_order(data, tmp_path,
                                                 monkeypatch):
    """RGL-Net's step: each round's graph layers in their regions, the
    batch norms of the edge and node MLPs nested inside them, the
    backward's regions in the reverse order of the forward's."""
    trainer = _trainer(data, tmp_path, 'rgl_net')
    T = int(trainer.cfg.model.gnn_iter)
    assert T == 3
    batch = next(iter(trainer.train_loader))
    launched = _launches(monkeypatch)
    _step(trainer, batch)
    assert _nesting(launched) == _rgl_regions(T)
    trainer.close()


def _counts(batch):
    """Each shape's valid parts of a loader's batch."""
    if 'part_counts' in batch:
        return [int(c) for c in batch['part_counts']]
    return [int(c) for c in (batch['part_valids'] > 0).sum(-1)]


def test_rgl_net_counters_count_a_small_batch(data, tmp_path):
    """`gnn.pair_rows` adds B x P x P rows for each pair MLP (the edge MLP
    each round, the RelationNet from the second), `gru.steps` layers x
    directions x P for each GRU call (one a round), and `data.valid_pairs`
    the sum of each shape's squared part count over the epoch's batches,
    beside `data.valid_parts`."""
    trainer = _trainer(data, tmp_path, 'rgl_net')
    T = int(trainer.cfg.model.gnn_iter)
    B, P = 2, 6
    tracing.reset()
    batches = list(trainer.train_loader)
    c = tracing.counters()
    counts = [_counts(b) for b in batches]
    assert len(batches) == 5
    assert c['data.valid_pairs'] == sum(n * n for s in counts for n in s)
    assert c['data.valid_parts'] == sum(map(sum, counts))
    assert c['data.valid_pairs'] > c['data.valid_parts']
    tracing.reset()
    _step(trainer, batches[0])
    c = tracing.counters()
    assert c['gnn.pair_rows'] == (2 * T - 1) * B * P * P
    assert c['gru.steps'] == T * 1 * 2 * P
    tracing.reset()
    trainer.model.eval()
    with torch.no_grad():
        trainer.model(trainer._augment(batches[1]), trainer.generator)
    assert tracing.counters() == {'gnn.pair_rows': (2 * T - 1) * B * P * P,
                                  'gru.steps': T * 2 * P}
    trainer.close()


def test_pending_backward_is_forgotten_between_steps(monkeypatch):
    """A forward without `end_backward` (a caller's own backward) leaves
    no `_bwd_end` for the next step: `step_vector` forgets it first."""
    launched = _launches(monkeypatch)
    x = torch.ones(3)
    tracing.region_begin('encoder', x)
    tracing.clear_backward()
    tracing.end_backward()
    assert launched == ['encoder_begin']
    assert TSTEP.tracing is tracing
