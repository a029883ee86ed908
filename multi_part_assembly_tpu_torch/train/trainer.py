"""Training and evaluation harness.

Port of multi_part_assembly_tpu/train/trainer.py for one device: the epoch
loop, validation every `val_every` epochs with batch-size-weighted metric
means, the sampled-assembly PLY export of each validation, checkpoints that
keep the 5 best epochs by `val/part_acc` with auto-resume from the newest,
weight loading, the test loop, and JSONL logging with an optional wandb
mirror.  Geometric batches come over the host wire's packed rows
(`data.wire_dtype`, default f16) or, with `data.device_sampling`, over the
slot wire, whose points the card samples itself (JAX trainer.py:267-311
and :537-548); semantic (PartNet) batches over the host wire's packed rows
or, with `data.device_table`, as slots into a resident table of the
split's clouds (JAX trainer.py:324-353 and :505-517).  Each loader places
its batches on the device on a thread of its own (`DevicePlacement`, JAX
`install_device_prep`): the copy, the expansion and the slot wire's
sampling overlap the steps in flight.  Checkpoints are saved
asynchronously (train/checkpoint.py, JAX's orbax manager with
`enable_async_checkpointing`).  One train step (JAX
parallel/mesh.py:122-140, train/step.py) augments a geometric batch on the
device (a PartNet batch carries its poses), runs `mon_loss`, takes its
gradient and an Adam step at the scheduled lr.

Dispatch (JAX trainer.py:518-610, 686-790): on a CUDA device with one
rank every train step is a replay of one captured CUDA graph
(train/step.py `CompiledStep`); on the CPU, under several ranks, and for a
config that `step.uncapturable` names, the same step runs eagerly.  The
epoch loop never waits for the device between steps: it takes
`exp.steps_per_call` batches from the loader (0: JAX's auto rule, 8 on a
slot wire on the card, else 1), queues their steps back to back, keeps
each step's log vector on the device, and writes the JSONL rows in one
fetch every `LOG_FLUSH_STEPS` steps, at the end of an epoch and before a
validation or a checkpoint.  The eval loop sums each batch's logs on the
device and fetches them once a loop.  The TPU runtime's execution kicks
and host-to-device probe have no counterpart here.

Data parallelism (parallel/dist.py; JAX parallel/mesh.py, trainer.py:
792-866): under several ranks each trains on its shard of the loader at
`cfg.exp.batch_size` a rank, from rank 0's weights; the gradients are
averaged over the ranks before clipping and Adam, so every rank takes the
same step; the eval sums are all-reduced in f64; rank 0 alone logs,
prints and writes checkpoints, and the PLY export runs only on one rank.
Rank r draws its augmentation and noise from a generator seeded
`rank_seed(exp.seed, r)`, which is exp.seed on rank 0.
"""

import json
import os
import time

import numpy as np
import torch

from ..datasets import build_dataloader
from ..datasets.device_sampler import sample_and_expand
from ..datasets.geometry import (augment_geometry_batch,
                                 enable_device_sampling,
                                 expand_geometry_batch, unpack_parts)
from ..datasets.part_table import gather_part_table
from ..datasets.partnet import enable_device_table
from ..models import build_model
from ..parallel import dist
from ..utils import tracing
from .checkpoint import CheckpointManager, load_state
from .core import mon_loss
from .state import build_optimizer, set_lr
from .step import CompiledStep, step_vector, steps_per_call, uncapturable

__all__ = ['Trainer', 'JSONLLogger', 'WandbLogger', 'NullLogger',
           'build_logger', 'device_sampling_enabled', 'device_table_enabled',
           'optimize_step', 'device_batch', 'DevicePlacement']

_SWITCH_WORDS = {'true': True, 'false': False, 'auto': 'auto'}
_HOST_KEYS = ('data_id', 'shape_id')  # host-only metadata
_READY = '__ready__'  # a placed batch's key: its CUDA event, or None


class JSONLLogger:
    """Metric sink: one JSON object per line, and the `echo` keys printed
    unless `quiet` (JAX trainer.py:120-148)."""

    def __init__(self, log_dir, name='metrics', quiet=False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f'{name}.jsonl')
        self.quiet = quiet
        self._f = open(self.path, 'a')

    def log(self, record, step=None, echo=None):
        record = {k: (float(v) if hasattr(v, 'item') else v)
                  for k, v in record.items()}
        if step is not None:
            record['step'] = int(step)
        self._f.write(json.dumps(record) + '\n')
        self._f.flush()
        if echo and not self.quiet:
            print('; '.join(f'{k}: {record[k]:.6f}' for k in echo
                            if k in record), flush=True)

    def log_assemblies(self, tag, gt_pcs, pred_pcs_list, valids, colors,
                       step=None, max_shapes=3):
        """Scalar sinks keep no assemblies: the PLY export of
        `Trainer._export_val_vis` is their record on disk."""

    def close(self):
        self._f.close()


class NullLogger:
    """The sink of ranks other than 0: it keeps nothing (JAX trainer.py:
    859)."""

    def log(self, record, step=None, echo=None):
        pass

    def log_assemblies(self, *args, **kwargs):
        pass

    def close(self):
        pass


class WandbLogger(JSONLLogger):
    """The JSONL sink with a wandb mirror (JAX trainer.py:151-207).  Without
    the `wandb` package, or when its init fails, it logs to JSONL only."""

    def __init__(self, log_dir, name='metrics', quiet=False,
                 project='multi_part_assembly_tpu', run_name=None,
                 config=None):
        super().__init__(log_dir, name=name, quiet=quiet)
        self._wandb = None
        try:
            import wandb
            self._wandb = wandb.init(project=project, name=run_name,
                                     dir=log_dir, config=config,
                                     resume='allow')
        except Exception as e:  # absent package, offline, failed login
            print(f'wandb unavailable ({e!r}); logging to JSONL only',
                  flush=True)

    def log(self, record, step=None, echo=None):
        super().log(record, step=step, echo=echo)
        if self._wandb is not None:
            numeric = {k: float(v) for k, v in record.items()
                       if isinstance(v, (int, float)) or hasattr(v, 'item')}
            self._wandb.log(numeric,
                            step=None if step is None else int(step))

    def log_assemblies(self, tag, gt_pcs, pred_pcs_list, valids, colors,
                       step=None, max_shapes=3):
        """The sampled assemblies as wandb.Object3D clouds of xyzrgb rows:
        the GT and each prediction of up to `max_shapes` shapes."""
        if self._wandb is None:
            return
        import wandb

        from ..utils.misc import colorize_part_pc, to_numpy
        gt, valids = to_numpy(gt_pcs), to_numpy(valids)
        colors = np.asarray(colors)
        preds = [to_numpy(p) for p in pred_pcs_list]
        objs = {}
        for b in range(min(max_shapes, gt.shape[0])):
            p = max(1, int(valids[b].sum()))
            objs[f'{tag}/gt_{b}'] = wandb.Object3D(
                colorize_part_pc(gt[b, :p], colors).reshape(-1, 6))
            for s, pred in enumerate(preds):
                objs[f'{tag}/pred{s}_{b}'] = wandb.Object3D(
                    colorize_part_pc(pred[b, :p], colors).reshape(-1, 6))
        self._wandb.log(objs, step=None if step is None else int(step))

    def close(self):
        if self._wandb is not None:
            self._wandb.finish()
        super().close()


def build_logger(cfg, log_dir, quiet=False):
    """`cfg.exp.wandb: True` adds the wandb mirror (JAX trainer.py:210);
    ranks other than 0 log nothing."""
    if dist.rank() != 0:
        return NullLogger()
    if cfg is not None and cfg.exp.get('wandb', False):
        return WandbLogger(
            log_dir, quiet=quiet,
            project=cfg.exp.get('wandb_project', 'multi_part_assembly_tpu'),
            run_name=cfg.exp.get('name', None))
    return JSONLLogger(log_dir, quiet=quiet)


def _to_device(batch, device):
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()
            if k not in _HOST_KEYS}


def device_batch(batch, cfg, device):
    """A host batch -> its tensors on `device`, before augmentation (JAX
    trainer.py:267-358): the host wire's packed rows are upcast and
    expanded, a geometric slot-wire batch is sampled (B5/B6, seeded by the
    batch) and expanded, and a PartNet batch's clouds are unpacked from the
    host wire's rows or gathered from the resident table."""
    if 'part_pcs__packed' in batch or 'part_slots' in batch:
        batch = dict(batch)
        ptable = batch.pop('__ptable__', None)
        dev = _to_device(batch, device)
        valids = dev['part_valids']
        if ptable is not None:
            dev['part_pcs'] = gather_part_table(
                ptable.table, dev.pop('part_slots'), valids)
        else:
            dev['part_pcs'] = unpack_parts(
                dev.pop('part_pcs__packed').float(),
                dev.pop('pack_index'), valids)
        return dev
    if 'part_slots__packed' in batch:
        batch = dict(batch)
        tables = batch.pop('__tables__')
        seed = int(batch.pop('sample_seed'))
        dev = _to_device(batch, device)
        return sample_and_expand(
            tables.table, tables.n_faces, dev['part_slots__packed'],
            dev['part_counts'], seed, n_points=int(cfg.data.num_pc_points),
            max_parts=int(cfg.data.max_num_part),
            data_keys=tuple(cfg.data.data_keys))
    if 'part_pcs_raw__packed' in batch:
        dev = _to_device(batch, device)
        return expand_geometry_batch(
            dev['part_pcs_raw__packed'], dev['part_counts'],
            max_parts=int(cfg.data.max_num_part),
            data_keys=tuple(cfg.data.data_keys))
    return _to_device(batch, device)


class DevicePlacement:
    """The loaders' `transform` stage (JAX trainer.py:364-383
    `install_device_prep`, one batch at a time): `device_batch` of each
    host batch on the loader's own thread, so that the copy to the card,
    the host wire's expansion and the slot wire's sampling overlap the
    steps in flight.  None of it reads trainer state: the slot wire's seed
    comes with the batch.

    On CUDA the work is issued on a stream of this stage's own, and the
    placed batch carries the event recorded after it (key `_READY`); the
    consumer (`Trainer._device_batch`) makes its stream wait on the event
    and marks the tensors used there before it touches them.  On the CPU
    the same work runs without streams (`_READY` None).  The host-only
    keys (`data_id`, `shape_id`) ride along for the loader's callers."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.stream = None
        if self.device.type == 'cuda':
            self.stream = torch.cuda.Stream(self.device)
            # after whatever the device holds so far (the tables)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def __call__(self, batch):
        ready = None
        if self.stream is None:
            out = device_batch(batch, self.cfg, self.device)
        else:
            with torch.cuda.stream(self.stream):
                out = device_batch(batch, self.cfg, self.device)
                ready = torch.cuda.Event()
                ready.record(self.stream)
        out.update({k: batch[k] for k in _HOST_KEYS if k in batch})
        out[_READY] = ready
        return out


def _switch(cfg, key, device, dataset):
    """`cfg.data.<key>`: True, False or 'auto', or one of the strings
    'true', 'false', 'auto' in any case (the key is absent from the
    configs, so `--opts data.<key> False` arrives as the string 'False',
    which the JAX trainer reads as on).  Any other value raises.  'auto' is
    on for `dataset` data on a CUDA device, as the JAX trainer's is on an
    accelerator."""
    value = cfg.data.get(key, 'auto')
    if isinstance(value, str) and value.lower() in _SWITCH_WORDS:
        value = _SWITCH_WORDS[value.lower()]
    elif not isinstance(value, bool):
        raise ValueError(f"data.{key}: expected True, False or 'auto', got "
                         f'{value!r}')
    if value == 'auto':
        return device.type == 'cuda' and cfg.data.dataset == dataset
    return value


def device_sampling_enabled(cfg, device):
    """Whether a geometric run samples its points on the device
    (`data.device_sampling`, JAX trainer.py:541-545)."""
    return _switch(cfg, 'device_sampling', device, 'geometry')


def device_table_enabled(cfg, device):
    """Whether a PartNet run keeps its clouds in a resident device table
    (`data.device_table`, JAX trainer.py:505-517)."""
    return _switch(cfg, 'device_table', device, 'partnet')


def optimize_step(model, optimizer, cfg, data, generator=None):
    """One optimisation step on an augmented device batch: the MoN loss,
    its gradients, the mean of the gradients over the ranks, clipping, then
    the optimizer's step at its groups' lr.  Returns the step's logs as
    floats, each the mean over the ranks (JAX parallel/mesh.py:122-140:
    the global batch's)."""
    keys, values = step_vector(model, optimizer, cfg, data, generator)
    return dict(zip(keys, values.tolist()))  # syncs


class Trainer:
    """Trains `cfg` on `device` ('cuda', 'cuda:N' or 'cpu'); a CUDA device
    that is absent raises, the CPU runs only when asked for.  Under several
    ranks a CUDA request means this rank's card (parallel/dist.py
    `rank_device`).  With `resume` it picks up from the newest checkpoint
    under `ckp_dir/models`.

    `train_epoch` replays the step's CUDA graph, `compiled` (captured at
    the first step), or runs the step eagerly where `compiled` is None;
    `train_step` is always one eager step that returns its logs.
    `step_seconds` has one entry a step of `train_epoch`: the wall time of
    the window of steps that ends in a synchronisation (a log flush, or
    the capture's own step) divided by its steps, the host's data waits
    inside it included."""

    # steps whose log vectors stay on the device before one fetch (JAX
    # trainer.py:686)
    LOG_FLUSH_STEPS = 32

    def __init__(self, cfg, device, ckp_dir=None, resume=True, quiet=False):
        # fp32 means fp32: no TF32 in matmuls or cuDNN convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = dist.rank_device(device)
        seed = cfg.exp.get('seed', 0)
        torch.manual_seed(seed)
        # seeded anew on resume, as the JAX trainer restarts its data key
        # from the seed (trainer.py:585-586); a stream of its own a rank
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(dist.rank_seed(seed))
        self.model = build_model(cfg, self.device)
        dist.broadcast_module(self.model)
        self._build_loaders(cfg)
        # one rank on the card: the optimizer is capturable even where a
        # config's step runs eagerly, so that an eager step and a replay
        # compute the same bits
        on_card = self.device.type == 'cuda' and dist.world() == 1
        self.optimizer, self.lr_schedule = build_optimizer(
            cfg, max(1, len(self.train_loader)), self.model,
            capturable=on_card)
        self.compiled = CompiledStep(self._step_vector, self.model,
                                     self.optimizer, self.generator) \
            if on_card and uncapturable(cfg) is None else None
        self.steps_per_call = steps_per_call(cfg, self.train_loader,
                                             self.device)
        self.ckp_dir = ckp_dir or cfg.exp.get('ckp_dir', 'checkpoint/')
        os.makedirs(self.ckp_dir, exist_ok=True)
        self.logger = build_logger(cfg, self.ckp_dir, quiet=quiet)
        self.ckpt_mgr = CheckpointManager(os.path.join(self.ckp_dir,
                                                       'models'))
        self.step = 0  # the host's count of dispatched steps
        self.start_epoch = 0
        self.step_seconds = []
        self._log_buf = []  # (log vectors [G, M], steps, lrs, data wait)
        self._log_keys = None
        self._window = None  # (start time, steps) since the last sync
        self.metrics = {}  # the last validation's
        self.test_results = None
        self._vis_skip_said = False
        if resume:
            self._try_resume()

    def _build_loaders(self, cfg):
        """The loaders, their wires, and their placement stage."""
        with tracing.span('setup.data', always=True):
            self.train_loader, self.val_loader = build_dataloader(cfg)
        loaders = (('train', self.train_loader), ('val', self.val_loader))
        # the slot wires, per split (None = the host wire): geometric
        # sampling tables, or PartNet's resident point table
        self.tables = {'train': None, 'val': None}
        self.part_tables = {'train': None, 'val': None}
        with tracing.span('setup.tables', always=True):
            if cfg.data.dataset == 'geometry':
                if device_sampling_enabled(cfg, self.device):
                    self.tables = {
                        name: enable_device_sampling(loader, cfg,
                                                     self.device)
                        for name, loader in loaders}
            elif device_table_enabled(cfg, self.device):
                self.part_tables = {
                    name: enable_device_table(loader, cfg, self.device)
                    for name, loader in loaders}
        for _, loader in loaders:
            loader.transform = DevicePlacement(cfg, self.device)

    # ------------------------------------------------------------------
    # checkpoints (JAX trainer.py:641-673)
    # ------------------------------------------------------------------
    def _load_state(self, state):
        self.model.load_state_dict(state['model'])
        # the groups keep this trainer's lr holder and capturable flag,
        # whichever device wrote the checkpoint
        own = [{k: g[k] for k in ('lr', 'capturable')}
               for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(state['optimizer'])
        # torch keeps Adam's step counts on the CPU unless the optimizer is
        # capturable or fused; map_location moved them with the rest
        for group, keep in zip(self.optimizer.param_groups, own):
            group.update(keep)
            for p in group['params']:
                st = self.optimizer.state.get(p, {})
                if torch.is_tensor(st.get('step')):
                    on_device = group['capturable'] or group.get('fused')
                    st['step'] = st['step'].to(p.device if on_device
                                               else 'cpu')
        self.step = int(state['step'])
        # the captured graph read the replaced optimizer state
        if self.compiled is not None:
            self.compiled.release()

    def _try_resume(self):
        self.ckpt_mgr.wait_until_finished()
        latest = self.ckpt_mgr.latest_step()
        if latest is None:
            return
        state = self.ckpt_mgr.restore(latest, self.device)
        self._load_state(state)
        self.start_epoch = int(state['epoch']) + 1
        if dist.rank() == 0:
            print(f'resumed from epoch {state["epoch"]} (step {self.step})',
                  flush=True)

    def save_checkpoint(self, epoch, metrics):
        """Start an asynchronous save of the model, optimizer, step and
        epoch (train/checkpoint.py): the state is copied to the host now
        and written by the manager's writer thread; it is on disk after
        `ckpt_mgr.wait_until_finished()`, the end of `fit` or `close`."""
        self._flush_train_logs()
        optimizer = self.optimizer.state_dict()
        for group in optimizer['param_groups']:  # a copy of each group
            if torch.is_tensor(group['lr']):
                group['lr'] = float(group['lr'])
        self.ckpt_mgr.save(epoch, {
            'model': self.model.state_dict(), 'optimizer': optimizer,
            'step': self.step, 'epoch': epoch}, metrics)

    def load_weights(self, path):
        """Load the model, optimizer and step of a checkpoint: its step
        directory (`models/<epoch>`, what `find_last_ckp` returns) or the
        state file in it."""
        self.ckpt_mgr.wait_until_finished()
        self._load_state(load_state(os.path.abspath(path), self.device))

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------
    def _device_batch(self, batch):
        """A batch from the loaders -> its tensors on the device, before
        augmentation.  A batch that the loader's placement stage made
        (`DevicePlacement`) is ready once this thread's stream waits on its
        event; its tensors are marked as used on that stream, so that the
        caching allocator keeps them until the steps that read them are
        done.  A host batch is placed here (`device_batch`).  The batch is
        not changed, so it may be used again."""
        if _READY not in batch:
            return device_batch(batch, self.cfg, self.device)
        ready = batch[_READY]
        batch = {k: v for k, v in batch.items()
                 if k != _READY and k not in _HOST_KEYS}
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def _augment_device(self, batch, generator=None):
        """A device batch, a geometric one augmented, its rotations drawn
        from `generator` (default: the trainer's); a PartNet batch carries
        its poses and is returned as it is."""
        if 'part_pcs_raw' not in batch:
            return batch
        batch = dict(batch)
        raw = batch.pop('part_pcs_raw')
        with tracing.region('augment', raw.device):
            aug = augment_geometry_batch(
                raw, batch['part_valids'],
                self.generator if generator is None else generator,
                rot_range=float(self.cfg.data.get('rot_range', -1.0)))
        return {**batch, **aug}

    def _augment(self, batch, generator=None):
        """A host batch -> the augmented batch on the device."""
        return self._augment_device(self._device_batch(batch), generator)

    def _step_vector(self, batch):
        """The whole train step on a device batch, augmentation included:
        the body that `CompiledStep` captures.  Returns the log vector."""
        self._log_keys, values = step_vector(
            self.model, self.optimizer, self.cfg,
            self._augment_device(batch), self.generator)
        return values

    def train_step(self, batch):
        """One eager step on a host batch; returns the step's logs (floats,
        so it synchronises)."""
        lr = self.lr_schedule(self.step)
        set_lr(self.optimizer, lr)
        values = self._step_vector(self._device_batch(batch))
        logs = dict(zip(self._log_keys, values.tolist()))  # syncs
        self.step += 1
        logs['lr'] = lr
        return logs

    def _dispatch(self, batches, waits):
        """Queue the steps of `batches` (host batches) back to back: one
        group of replays, or eager steps, without waiting for the device,
        their logs buffered.  A step that captures the graph synchronises
        and is timed as a window of its own."""
        with tracing.span('train.dispatch', step=self.step + 1,
                          steps=len(batches)):
            rows, lrs = None, []
            first = self.step
            for g, batch in enumerate(batches):
                lr = self.lr_schedule(self.step)
                lrs.append(lr)
                set_lr(self.optimizer, lr)
                data = self._device_batch(batch)
                tracing.count('step.slots', data['part_valids'].numel())
                capture = self.compiled is not None and \
                    self.compiled.needs_capture(data)
                if capture:
                    self._close_window()
                if self._window is None:
                    self._window = [time.perf_counter(), 0]
                values = self._step_vector(data) if self.compiled is None \
                    else self.compiled(data)
                if rows is None:
                    rows = values.new_empty((len(batches), values.shape[0]))
                rows[g].copy_(values)
                self.step += 1
                self._window[1] += 1
                if capture:
                    self._close_window()
            steps = tuple(range(first + 1, self.step + 1))
            self._log_buf.append((rows, steps, lrs, sum(waits)))

    def _close_window(self):
        """Synchronise and give each step of the open window its mean wall
        time."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        if self._window is not None and self._window[1]:
            t0, n = self._window
            self.step_seconds += [(time.perf_counter() - t0) / n] * n
        self._window = None

    def _buffered_steps(self):
        return sum(len(steps) for _, steps, _, _ in self._log_buf)

    def _flush_train_logs(self):
        """Fetch every buffered step's logs in one copy, write one JSONL
        row a step, and close the timing window (JAX trainer.py:700-743).
        A group's data wait is spread over its steps.  Returns the last
        step's logs, or None when nothing was buffered."""
        with tracing.span('train.flush', steps=self._buffered_steps()):
            if not self._log_buf:
                self._close_window()
                return None
            mats = torch.cat([rows for rows, _, _, _ in self._log_buf])
            with tracing.span('train.flush.fetch'):
                table = mats.tolist()  # the one fetch: it synchronises
            self._close_window()
            last, i = None, 0
            with tracing.span('train.flush.write'):
                for _, steps, lrs, wait in self._log_buf:
                    for step_no, lr in zip(steps, lrs):
                        logs = dict(zip(self._log_keys, table[i]))
                        logs['lr'] = lr
                        logs['data_time'] = wait / len(steps)
                        self.logger.log(
                            {f'train/{k}': v for k, v in logs.items()},
                            step=step_no)
                        last, i = logs, i + 1
            self._log_buf.clear()
            return last

    def train_epoch(self, epoch):
        """One epoch of dispatch-only steps (JAX trainer.py:745-790):
        `steps_per_call` batches are taken from the loader, then their
        steps queued back to back; the tail of an epoch that does not fill
        a group runs as single steps.  Logs are flushed every
        `LOG_FLUSH_STEPS` steps and at the end.  Returns the last step's
        logs (None for an empty epoch).  The spans `train.epoch`, and
        `train.gather` for the taking of a group's batches
        (utils/tracing.py)."""
        with tracing.span('train.epoch', epoch=epoch):
            return self._train_epoch(epoch)

    def _train_epoch(self, epoch):
        self.train_loader.set_epoch(epoch)
        group, waits = [], []
        gather = tracing.span('train.gather', epoch=epoch,
                              step=self.step + 1)
        gather.__enter__()
        t_last = time.perf_counter()
        try:
            for batch in self.train_loader:
                waits.append(time.perf_counter() - t_last)
                group.append(batch)
                if len(group) == self.steps_per_call:
                    gather.__exit__(None, None, None)
                    self._dispatch(group, waits)
                    group, waits = [], []
                    if self._buffered_steps() >= self.LOG_FLUSH_STEPS:
                        self._flush_train_logs()
                    gather = tracing.span('train.gather', epoch=epoch,
                                          step=self.step + 1)
                    gather.__enter__()
                t_last = time.perf_counter()
        finally:
            gather.__exit__(None, None, None)
        for batch, wait in zip(group, waits):  # the tail, step by step
            self._dispatch([batch], [wait])
        return self._flush_train_logs()

    @torch.no_grad()
    def _eval_loop(self, loader, prefix):
        """Batch-size weighted means of the per-element eval logs
        (JAX trainer.py:792-854).  Each key's batch sum (f32, as before)
        is added to a f64 vector on the device, fetched once a loop; under
        several ranks the sums and the weight are all-reduced in f64 once,
        so every rank returns the same."""
        self.model.eval()
        keys, sums, weight = None, None, 0
        for batch in loader:
            data = self._augment(batch)
            _, logs = mon_loss(self.model, data, cfg=self.cfg,
                               training=False, reduce=False,
                               generator=self.generator)
            keys = keys or list(logs)
            vec = torch.stack([logs[k].sum() for k in keys]).double()
            sums = vec if sums is None else sums + vec
            weight += data['part_valids'].shape[0]
        keys = keys or []
        total = torch.tensor([float(weight)], dtype=torch.float64,
                             device=self.device)
        if sums is not None:
            total = torch.cat([sums, total])
        if dist.world() > 1:
            dist.all_reduce_(total)
        total = total.tolist()  # the one fetch
        weight = total[-1]
        return {f'{prefix}/{k}': v / max(weight, 1)
                for k, v in zip(keys, total[:-1])}

    def validate(self, epoch):
        self._flush_train_logs()  # keeps the JSONL in step order
        metrics = self._eval_loop(self.val_loader, 'val')
        self.logger.log(metrics, step=self.step, echo=sorted(metrics))
        n_vis = self.cfg.exp.get('val_sample_vis', 0)
        if n_vis and n_vis > 0:
            # one rank's forward passes only (JAX trainer.py:866)
            if dist.world() == 1:
                self._export_val_vis(epoch, n_vis)
            elif dist.rank() == 0 and not self._vis_skip_said:
                print('val PLY export skipped: it runs on one rank only',
                      flush=True)
                self._vis_skip_said = True
        return metrics

    @torch.no_grad()
    def _export_val_vis(self, epoch, n_vis):
        """PLY export of sampled assemblies on the first batch of the train
        and of the val loader (JAX trainer.py:870-904).  The batch is
        augmented from a generator seeded by `epoch`; the noise of the
        samples comes from the trainer's generator."""
        from .vis_utils import export_assembly_samples, sample_assembly
        colors = self.cfg.data.get('colors', [[127, 127, 127]] * 21)
        self.model.eval()
        for split, loader in (('train', self.train_loader),
                              ('val', self.val_loader)):
            batches = iter(loader)
            batch = next(batches, None)
            batches.close()  # stops the loader's producer thread
            if batch is None:
                continue
            aug = torch.Generator(device=self.device).manual_seed(epoch)
            data = self._augment(batch, aug)
            gt_pcs, preds = sample_assembly(
                self.model, data, self.generator,
                rot_type=self.cfg.model.rot_type,
                sample_iter=self.cfg.loss.get('sample_iter', 1))
            valids = data['part_valids']
            n = min(n_vis, valids.shape[0])
            export_assembly_samples(
                gt_pcs, preds, valids, colors,
                os.path.join(self.ckp_dir, 'vis'),
                prefix=f'epoch{epoch}_{split}', max_shapes=n)
            self.logger.log_assemblies(f'assembly/{split}', gt_pcs, preds,
                                       valids, colors, step=self.step,
                                       max_shapes=n)

    def fit(self):
        """Train from `start_epoch`, validating and saving a checkpoint
        every `val_every` epochs and after the last (JAX
        trainer.py:906-922); each save's write overlaps the epochs after
        it, and the last is on disk when this returns.  Returns the last
        validation's metrics."""
        cfg = self.cfg
        for epoch in range(self.start_epoch, cfg.exp.num_epochs):
            t0 = time.perf_counter()
            logs = self.train_epoch(epoch)
            if logs is not None and dist.rank() == 0:
                print(f'epoch {epoch}: loss={logs["loss"]:.6f} '
                      f'({time.perf_counter() - t0:.1f}s)', flush=True)
            if (epoch + 1) % cfg.exp.val_every == 0 or \
                    epoch == cfg.exp.num_epochs - 1:
                self.metrics = self.validate(epoch)
                self.save_checkpoint(epoch, self.metrics)
        self.ckpt_mgr.wait_until_finished()
        return self.metrics

    def swap_loaders(self, cfg):
        """Point the data pipeline at another cfg, such as another category,
        keeping the model and optimizer (JAX trainer.py:924-935)."""
        assert cfg.data.max_num_part == self.cfg.data.max_num_part, \
            'swap_loaders requires category-invariant batch shapes'
        self.cfg = cfg
        self._build_loaders(cfg)

    def test(self):
        """Evaluate on the val split as `test/*` (JAX trainer.py:937-944)."""
        self._flush_train_logs()
        metrics = self._eval_loop(self.val_loader, 'test')
        if dist.rank() == 0:
            print('; '.join(f'{k}: {v:.6f}'
                            for k, v in sorted(metrics.items())), flush=True)
        self.test_results = metrics
        return metrics

    def close(self):
        """Flush the logs, finish the pending save, close the sink and free
        the captured graph (JAX trainer.py:946-950)."""
        self._flush_train_logs()
        self.ckpt_mgr.wait_until_finished()
        if self.compiled is not None:
            self.compiled.release()
        self.logger.close()
