"""A minimal trainer: build, train epochs, validate, log.

Port of the core of multi_part_assembly_tpu/train/trainer.py (fit,
train_epoch, the batch-size-weighted eval loop, JSONL logging).  Batches
come over the host wire or, with `data.device_sampling`, over the slot
wire, whose points the card samples itself (JAX trainer.py:267-311 and
:537-548, single device).  One train step (JAX parallel/mesh.py:122-140)
augments the batch on the device, runs `mon_loss`, takes its gradient and
an Adam step at the scheduled lr.  Checkpoints, auto-resume, data
parallelism and the visual export are not ported yet.
"""

import json
import os
import time

import torch

from ..datasets.device_sampler import sample_and_expand
from ..datasets.geometry import (augment_geometry_batch,
                                 build_geometry_dataloader,
                                 enable_device_sampling)
from ..models import build_model
from .core import mon_loss
from .state import build_optimizer, clip_gradients

__all__ = ['Trainer', 'JSONLLogger', 'device_sampling_enabled']

_SAMPLING_WORDS = {'true': True, 'false': False, 'auto': 'auto'}


class JSONLLogger:
    """One JSON object per line, optionally echoed to stdout."""

    def __init__(self, log_dir, name='metrics'):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f'{name}.jsonl')
        self._f = open(self.path, 'a')

    def log(self, record, step=None, echo=False):
        record = dict(record)
        if step is not None:
            record['step'] = int(step)
        self._f.write(json.dumps(record) + '\n')
        self._f.flush()
        if echo:
            print('; '.join(f'{k}: {v:.6f}' for k, v in sorted(
                record.items()) if isinstance(v, float)), flush=True)

    def close(self):
        self._f.close()


def _to_device(batch, device):
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()
            if k != 'data_id'}


def device_sampling_enabled(cfg, device):
    """Whether the run samples its points on the device.

    `data.device_sampling` is True, False or 'auto', or one of the strings
    'true', 'false', 'auto' in any case: the key is absent from the
    configs, so `--opts data.device_sampling False` arrives as the string
    'False' (which the JAX trainer, trainer.py:541-545, reads as on).  Any
    other value raises.  'auto' is on for geometry data on a CUDA device,
    as the JAX trainer's is on an accelerator."""
    value = cfg.data.get('device_sampling', 'auto')
    if isinstance(value, str) and value.lower() in _SAMPLING_WORDS:
        value = _SAMPLING_WORDS[value.lower()]
    elif not isinstance(value, bool):
        raise ValueError("data.device_sampling: expected True, False or "
                         f"'auto', got {value!r}")
    if value == 'auto':
        return device.type == 'cuda' and cfg.data.dataset == 'geometry'
    return value


class Trainer:
    """Trains `cfg` on `device` ('cuda', 'cuda:N' or 'cpu'); a CUDA device
    that is absent raises, the CPU runs only when asked for."""

    def __init__(self, cfg, device, ckp_dir=None):
        # fp32 means fp32: no TF32 in matmuls or cuDNN convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(f'device {device!r} asked for, but no CUDA '
                               'device is available; pass the CPU '
                               'explicitly to train there')
        seed = cfg.exp.get('seed', 0)
        torch.manual_seed(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.model = build_model(cfg).to(self.device)
        self.train_loader, self.val_loader = build_geometry_dataloader(cfg)
        # the slot wire: tables per split (None = the host wire)
        self.tables = {'train': None, 'val': None}
        if device_sampling_enabled(cfg, self.device):
            self.tables = {
                name: enable_device_sampling(loader, cfg, self.device)
                for name, loader in (('train', self.train_loader),
                                     ('val', self.val_loader))}
        self.optimizer, self.lr_schedule = build_optimizer(
            cfg, max(1, len(self.train_loader)), self.model)
        self.ckp_dir = ckp_dir or cfg.exp.get('ckp_dir', 'checkpoint/')
        self.logger = JSONLLogger(self.ckp_dir)
        self.step = 0
        self.step_seconds = []  # wall time of each train step, synchronised
        self.metrics = {}  # the last validation's

    def _augment(self, batch):
        """A host batch -> the augmented batch on the device.  A slot-wire
        batch is sampled and expanded on the device first."""
        if 'part_slots__packed' in batch:
            batch = dict(batch)
            tables = batch.pop('__tables__')
            seed = int(batch.pop('sample_seed'))
            dev = _to_device(batch, self.device)
            batch = sample_and_expand(
                tables.table, tables.n_faces, dev['part_slots__packed'],
                dev['part_counts'], seed,
                n_points=int(self.cfg.data.num_pc_points),
                max_parts=int(self.cfg.data.max_num_part),
                data_keys=tuple(self.cfg.data.data_keys))
        else:
            batch = _to_device(batch, self.device)
        aug = augment_geometry_batch(
            batch.pop('part_pcs_raw'), batch['part_valids'], self.generator,
            rot_range=float(self.cfg.data.get('rot_range', -1.0)))
        return {**batch, **aug}

    def train_step(self, batch):
        """One step on a host batch; returns the step's logs (floats)."""
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.model.train()
        data = self._augment(batch)
        loss, logs = mon_loss(self.model, data, cfg=self.cfg, training=True,
                              generator=self.generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_gradients(self.cfg, self.model)
        self.optimizer.step()
        self.step += 1
        logs = {k: float(v.detach()) for k, v in logs.items()}  # syncs
        logs['lr'] = lr
        return logs

    def train_epoch(self, epoch):
        self.train_loader.set_epoch(epoch)
        logs = None
        t_last = time.perf_counter()
        for batch in self.train_loader:
            t_data = time.perf_counter() - t_last
            t0 = time.perf_counter()
            logs = self.train_step(batch)
            self.step_seconds.append(time.perf_counter() - t0)
            logs['data_time'] = t_data
            self.logger.log({f'train/{k}': v for k, v in logs.items()},
                            step=self.step)
            t_last = time.perf_counter()
        return logs

    @torch.no_grad()
    def _eval_loop(self, loader, prefix):
        """Batch-size weighted means of the per-element eval logs
        (JAX trainer.py:792-854)."""
        self.model.eval()
        sums, weight = {}, 0
        for batch in loader:
            data = self._augment(batch)
            _, logs = mon_loss(self.model, data, cfg=self.cfg,
                               training=False, reduce=False,
                               generator=self.generator)
            for k, v in logs.items():
                sums[k] = sums.get(k, 0.0) + float(v.sum())
            weight += data['part_valids'].shape[0]
        return {f'{prefix}/{k}': v / max(weight, 1) for k, v in sums.items()}

    def validate(self, epoch):
        metrics = self._eval_loop(self.val_loader, 'val')
        self.logger.log(metrics, step=self.step, echo=True)
        return metrics

    def fit(self):
        cfg = self.cfg
        for epoch in range(cfg.exp.num_epochs):
            t0 = time.perf_counter()
            logs = self.train_epoch(epoch)
            if logs is not None:
                print(f'epoch {epoch}: loss={logs["loss"]:.6f} '
                      f'({time.perf_counter() - t0:.1f}s)', flush=True)
            if (epoch + 1) % cfg.exp.val_every == 0 or \
                    epoch == cfg.exp.num_epochs - 1:
                self.metrics = self.validate(epoch)
        return self.metrics

    def close(self):
        self.logger.close()
