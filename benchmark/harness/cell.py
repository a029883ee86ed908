"""One run of one cell: set-up, the measured window, the traced epoch, the
correctness check, and the result line.

Set-up builds the port's `Trainer` for the cell (its loaders and their
wire, the mesh registry and the device tables, the model and a capturable
Adam), loads the initial weights that `weights.make_weights` makes on the
device from the seed, and drives the trainer through epoch 0 by
`Trainer._dispatch`, the call that `train_epoch` makes for each group:
the first step alone (it captures the CUDA graph, after its two undone
warm-up steps), its gradient read from the optimizer, then the next steps
as `train_epoch` dispatches them (one group of `steps_per_call`, or two
single steps), the weights read, then the rest of the epoch in groups and
a log flush.  The window then calls `Trainer.train_epoch` for epochs
1, 2, ... until `seconds` have passed, and closes on a synchronised flush:
the loader, its placement thread, the wire, the grouped replays, the
flushes and the epoch boundaries are all inside it.  No validation or
checkpoint runs.  A traced run adds, after the window, one epoch under
torch.profiler.  Once the window has closed and the peak memory is read,
the trainer is freed and the reference follows the checked steps.
"""

import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from . import compare, spec
from .trace import Trace, WINDOW
from .weights import load_weights, make_weights
from ..reference import data as ref_data
from ..reference.loss import loss_weights
from ..reference.train import run_steps



def check_steps(steps_per_call):
    """The steps the check compares: the first alone, then one group of
    `steps_per_call` (at least two single steps)."""
    return 1 + max(2, int(steps_per_call))


class MemoryLogger:
    """The trainer's metric sink, kept in memory: one dict a record."""

    def __init__(self):
        self.records = []

    def log(self, record, step=None, echo=None):
        self.records.append(dict(record, step=step))

    def close(self):
        pass


class _Spans:
    """The train loader seen through `bench.data_wait` host ranges around
    each hand-over of a batch."""

    def __init__(self, loader):
        self._loader = loader

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __iter__(self):
        it = iter(self._loader)
        try:
            while True:
                with torch.profiler.record_function('bench.data_wait'):
                    batch = next(it, None)
                if batch is None:
                    return
                yield batch
        finally:
            it.close()


def _ranged(fn, name):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _items(cfg):
    d = cfg['data']
    fn = d['data_fn'].format('train')
    if d['dataset'] == 'geometry':
        items = ref_data.geometry_items(d['data_dir'], fn,
                                        int(d['min_num_part']),
                                        int(d['max_num_part']))
        return [len(files) for _, files in items]
    items = ref_data.partnet_items(d['data_dir'], fn, int(d['min_num_part']),
                                   int(d['max_num_part']))
    return [np.load(p, allow_pickle=True).item()['part_pcs'].shape[0]
            for _, p in items]


def batch_counts(cfg, counts, epoch):
    """The valid part counts of each batch of an epoch."""
    return [[counts[int(i)] for i in idx] for idx in ref_data.epoch_batches(
        len(counts), int(cfg['exp']['batch_size']), int(cfg['exp']['seed']),
        epoch)]


def load_reader(name):
    path = os.path.join(spec.BENCH_DIR, 'metrics', f'{name}.py')
    mod_spec = importlib.util.spec_from_file_location(
        f'benchmark_metric_{name}', path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def power_limit():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20).stdout.strip()
        return out.splitlines()[0] if out else 'not read'
    except (OSError, subprocess.SubprocessError):
        return 'not read'


def run(config, traffic, limits, per_layer, seed, seconds, trace,
        device='cuda', log=print):
    """Run the cell once; returns the result object (the last line)."""
    cuda = torch.device(device).type == 'cuda'
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='bench-')  # under the run's TMPDIR
    phases = {}
    try:
        trainer, logger, cfg_dict, params0, prog = build(
            config, traffic, seed, device, tmp, phases)
        setup_s = time.perf_counter() - t_start

        # -- the measured window ------------------------------------------
        step0, epoch = trainer.step, 1
        t0 = time.perf_counter()
        ends = []
        while True:
            trainer.train_epoch(epoch)
            epoch += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        _sync(trainer.device)
        window_s = time.perf_counter() - t0
        steps = trainer.step - step0
        window_logs = list(logger.records)
        peak = torch.cuda.max_memory_allocated(trainer.device) if cuda \
            else 0
        rec = {'cfg': cfg_dict, 'logs': window_logs,
               'window': {'seconds': window_s, 'steps': steps,
                          'epochs': list(range(1, epoch))}}
        tr = None
        if trace:
            tr = _traced_epoch(trainer, epoch)
            counts = _items(cfg_dict)
            rec['window']['batch_counts'] = [
                c for e in rec['window']['epochs']
                for c in batch_counts(cfg_dict, counts, e)]
            rec['trace'] = {'trace': tr, 'batch_counts':
                            batch_counts(cfg_dict, counts, epoch)}
        batch = int(cfg_dict['exp']['batch_size'])
        losses = [r.get('train/loss', math.nan) for r in window_logs]
        failed = sum(not math.isfinite(x) for x in losses)
        free(trainer)
        del trainer
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- the reference, once the window has closed ---------------------------
    t_ref = time.perf_counter()
    ref = run_steps(cfg_dict, traffic['wire'], params0, seed,
                    len(prog['loss']), torch.device(device))
    detail = {}
    values = compare.readings(prog, ref, params0, loss_weights(cfg_dict),
                              detail)
    correct, checks = compare.judge(values, limits)
    correct = correct and failed == 0
    log(f'reference: {time.perf_counter() - t_ref:.1f} s; {values}; '
        f'{detail}')
    log('losses: ' + json.dumps({'program': prog['loss'],
                                 'reference': ref['loss']}))

    if trace:
        metrics = {}
        for m in per_layer:
            value = load_reader(m['name'])(rec)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        metrics = {
            'train_samples_per_s': {'value': steps * batch / window_s,
                                    'unit': 'samples/s'},
            'peak_mem_gib': {'value': peak / 2**30, 'unit': 'GiB'},
            'setup_s': {'value': setup_s, 'unit': 's'},
        }
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
           'count': 1, 'memory_peak_bytes': int(peak)}
    out = {'correct': bool(correct), 'attempted': steps, 'failed': failed,
           'metrics': metrics, 'device': dev}
    if tr is not None and tr.span is not None:
        dev['busy_s'] = tr.busy_s
        dev['window_s'] = tr.window_s
        out['breakdown'] = {'device_ops': tr.top_ops(),
                            'idle_gaps': tr.idle_gaps()}
    log(f'window: {steps} steps in {window_s:.3f} s over epochs 1-'
        f'{epoch - 1}; set-up {setup_s:.3f} s; peak {peak} bytes')
    log('set-up s: ' + ', '.join(f'{k} {v:.3f}' for k, v in phases.items())
        + '; epochs of the window, s: ' + ' '.join(
            f'{b - a:.3f}' for a, b in zip([0.0] + ends, ends)))
    out['checks'] = checks
    return out


def build(config, traffic, seed, device, tmp, phases=None):
    """The set-up of a run: the trainer for the cell with its checkpoint
    directory `tmp`, the initial weights from the seed loaded, driven
    through epoch 0.  Returns (trainer, logger, the run's configuration,
    the initial weights, the program's side of the check).  `phases`, a
    dict, receives the seconds of each part of it."""
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    from multi_part_assembly_tpu_torch.utils.config_utils import CfgNode

    phases = {} if phases is None else phases
    t = time.perf_counter()

    def done(name):
        nonlocal t
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    data_dir = spec.ensure_data(traffic)
    cfg_dict = spec.run_config(config, traffic, data_dir, seed)
    done('data')
    trainer = Trainer(CfgNode(cfg_dict), device, ckp_dir=tmp, resume=False,
                      quiet=True)
    done('trainer')
    trainer.logger.close()
    logger = trainer.logger = MemoryLogger()
    slot = trainer.tables['train'] is not None or \
        trainer.part_tables['train'] is not None
    if slot != (traffic['wire'] == 'slot'):
        raise RuntimeError(
            f"the trainer is on the {'slot' if slot else 'host'} wire, "
            f"the traffic asks for {traffic['wire']}")
    params0 = make_weights([(n, tuple(p.shape)) for n, p in
                            trainer.model.named_parameters()], seed,
                           trainer.device)
    load_weights(trainer.model, params0)
    # the default generators (dropout's) from the seed at the first step,
    # as the reference starts them: on the CPU the model's own
    # initialisation has drawn from them since the trainer seeded them
    torch.manual_seed(int(seed))
    done('weights')
    prog = _first_steps(trainer, logger)
    done('epoch0')
    return trainer, logger, cfg_dict, params0, prog


def free(trainer):
    """Close the trainer and give its device memory back."""
    cuda = trainer.device.type == 'cuda'
    trainer.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def _first_steps(trainer, logger):
    """Epoch 0: the first step alone, the first gradient read from the
    optimizer; the next as `train_epoch` dispatches them (one group of
    `steps_per_call`, or two single steps), the weights read; then the rest
    of the epoch in groups and a flush.  The whole epoch warms what the
    program fills on first use (the host wire's mesh registry, the PartNet
    labels).  Returns the program's side of the check."""
    loader = trainer.train_loader
    loader.set_epoch(0)
    spc = trainer.steps_per_call
    n = check_steps(spc)
    it = iter(loader)
    try:
        trainer._dispatch([next(it)], [0.0])
        _sync(trainer.device)
        grad = compare.program_grad(
            trainer.optimizer, trainer.model,
            trainer.optimizer.param_groups[0]['betas'][0])
        rest = [next(it) for _ in range(n - 1)]
        for i in range(0, n - 1, spc):
            trainer._dispatch(rest[i:i + spc], [0.0] * len(rest[i:i + spc]))
        _sync(trainer.device)
        params = compare.snapshot(trainer.model)
        group = []
        for batch in it:
            group.append(batch)
            if len(group) == trainer.steps_per_call:
                trainer._dispatch(group, [0.0] * len(group))
                group = []
        for batch in group:
            trainer._dispatch([batch], [0.0])
    finally:
        it.close()
    trainer._flush_train_logs()
    losses = [{k[len('train/'):]: v for k, v in r.items()
               if k.startswith('train/')}
              for r in logger.records[:n]]
    logger.records.clear()
    return {'loss': losses, 'grad': grad, 'params': params}


def _traced_epoch(trainer, epoch):
    """One more epoch under torch.profiler, inside the host range
    `bench.window`, with `bench.*` ranges around the loader's hand-overs,
    the dispatches and the log flushes."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if trainer.device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    loader = trainer.train_loader
    trainer.train_loader = _Spans(loader)
    trainer._dispatch = _ranged(trainer._dispatch, 'bench.dispatch')
    trainer._flush_train_logs = _ranged(trainer._flush_train_logs,
                                        'bench.flush')
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                trainer.train_epoch(epoch)
                _sync(trainer.device)
    finally:
        trainer.train_loader = loader
        del trainer._dispatch, trainer._flush_train_logs
    return Trace(prof)
