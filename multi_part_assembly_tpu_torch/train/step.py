"""The train step: its body, its logs as one vector, and its CUDA graph.

Port of multi_part_assembly_tpu/parallel/mesh.py:122-290 and
train/trainer.py:518-526.  `step_vector` is one optimisation step on an
augmented device batch (`_train_step_body`): the MoN loss, its gradients,
their mean over the ranks, clipping and the optimizer's step, its logs
stacked into one f32 vector in sorted key order (`_stack_dict`), without a
host synchronisation.  `CompiledStep` is the counterpart of
`make_train_step_stacked`'s jit: the whole step, the caller's augmentation
included, captured once as one `torch.cuda.CUDAGraph` over static input
buffers and replayed for every later batch of the same shapes; a group of
`exp.steps_per_call` steps (`make_train_step_multi`'s scan) is that many
replays queued back to back (`Trainer.train_epoch`).

What is captured and what is not:
  * inside the graph: the geometric augmentation, `mon_loss` forward (the
    pose head's noise, LSTM's teacher-forcing draw, semantic matching with
    kernel L1), backward, the zero gradient of parameters the loss does not
    reach, clipping, Adam/AdamW with `capturable=True` at the lr held in a
    device scalar, and the stacked logs;
  * in front of each replay, on the same stream: the wait on the batch's
    placement event (whatever makes the batch on the device, the host
    wire's copy and expansion, the slot wire's `sample_and_expand`, whose
    packed rows vary a batch, the semantic wire's unpack or table gather,
    runs on the loader's own thread and stream: train/trainer.py
    `DevicePlacement`), the copy of the batch into the static inputs, and
    the `fill_` of the lr for the step's index in `train/schedules.py`;
  * never captured: a step on the CPU, or under several ranks (gloo stages
    every collective through the host, parallel/dist.py), and a config that
    `uncapturable` names.  Those run `step_vector` eagerly.

Random draws come from the trainer's generator (and dropout's from the
default CUDA generator): both are registered with the graph, so that a
replay draws what the eager step would have drawn and advances the
generators as far.  Before the capture, `WARMUP_STEPS` eager steps on a side
stream reach every lazy initialisation (Adam's state, cuBLAS, the kernels'
one-time attributes), and are then undone: parameters, buffers, optimizer
state and generator states are put back bitwise, so the first step a caller
asks for is already a replay.
"""

import time

import torch

from ..parallel import dist
from .core import mon_loss
from .state import clip_gradients

__all__ = ['step_vector', 'CompiledStep', 'uncapturable', 'slot_wire',
           'steps_per_call', 'WARMUP_STEPS']

WARMUP_STEPS = 2

# configs whose step is not captured, (key, value) -> what blocks it;
# `Trainer` runs their steps eagerly.  A graph's private pool keeps every
# activation of the step for the whole run (an eager step returns them to
# the cache for validation to reuse)
_UNCAPTURABLE = {
    ('model.encoder', 'pointnet2_ssg'):
        'the grouped layers\' activations, about 43 GiB a step at batch 32 '
        '(H100, 80 GB), held by the graph beside validation run out of '
        'the card',
    ('model.encoder', 'pointnet2_msg'):
        'the grouped layers\' activations, about 46 GiB a step at batch 16 '
        '(H100, 80 GB), run out of the card in the capture itself',
}


def uncapturable(cfg):
    """The reason a config's train step cannot be captured as a CUDA graph,
    or None when it can."""
    for (key, value), reason in _UNCAPTURABLE.items():
        section, name = key.split('.')
        if cfg[section].get(name, None) == value:
            return f'{key} {value}: {reason}'
    return None


def slot_wire(loader):
    """Whether a loader ships slots into resident device tables: sampling
    tables (geometric) or the part table (PartNet)."""
    ds = loader.dataset
    return getattr(ds, '_device_tables', None) is not None or \
        getattr(ds, '_device_ptable', None) is not None


def steps_per_call(cfg, loader, device):
    """`exp.steps_per_call`; 0 (or absent) is JAX's auto rule
    (trainer.py:518-526): 8 when the train loader is on a slot wire on a
    CUDA device, otherwise 1."""
    spc = int(cfg.exp.get('steps_per_call', 0) or 0)
    if spc > 0:
        return spc
    return 8 if torch.device(device).type == 'cuda' and slot_wire(loader) \
        else 1


def step_vector(model, optimizer, cfg, data, generator=None):
    """One optimisation step on an augmented device batch; returns (sorted
    log keys, the logs as one f32 vector), each log the mean over the ranks
    (JAX parallel/mesh.py:122-140 and `_stack_dict` :178-189).  Nothing in
    it waits for the device on one rank."""
    model.train()
    loss, logs = mon_loss(model, data, cfg=cfg, training=True,
                          generator=generator)
    optimizer.zero_grad(set_to_none=True)
    if loss.requires_grad:  # identity's loss needs no gradient
        loss.backward()
    # JAX differentiates every parameter: one the loss does not reach
    # (identity's dummy, LSTM's stop-sign head) takes a zero gradient,
    # and Adam counts the step for it as optax does
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    dist.average_gradients(params)
    clip_gradients(cfg, model)  # the global gradient, as JAX clips
    optimizer.step()
    keys = sorted(logs)
    values = torch.stack([logs[k].detach().float() for k in keys])
    if dist.world() > 1:
        values = dist.all_reduce_(values) / dist.world()
    return keys, values


class CompiledStep:
    """`body(batch) -> f32 log vector`, a whole train step on a dict of
    device tensors, run as replays of one captured CUDA graph.

    The first call (and a call whose batch differs in keys, shapes or
    dtypes from the captured one) captures: `WARMUP_STEPS` eager bodies on a
    side stream, undone, then one capture, then the replay.  Every call
    copies its batch into the static inputs and replays, on the current
    stream, without waiting for the device; it returns the graph's static
    log vector, which the next replay overwrites.

    Counters for the callers' checks: `traced`, the bodies run in Python
    (warm-ups and captures: the launch counters of the kernels' wrappers
    count these, not replays); `replays`; `captures`, and `capture_seconds`
    their wall time, warm-ups included."""

    def __init__(self, body, model, optimizer, generator):
        self.body = body
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.graph = None
        self.static_in = None
        self.static_out = None
        self.traced = 0
        self.replays = 0
        self.captures = 0
        self.capture_seconds = 0.0

    def needs_capture(self, batch):
        """Whether a call on `batch` captures: no graph yet, or one
        captured on other keys, shapes or dtypes."""
        s = self.static_in
        return self.graph is None or s.keys() != batch.keys() or any(
            s[k].shape != v.shape or s[k].dtype != v.dtype
            for k, v in batch.items())

    def __call__(self, batch):
        if self.needs_capture(batch):
            self._capture(batch)
        else:
            for k, v in batch.items():
                self.static_in[k].copy_(v, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        return self.static_out

    def release(self):
        """Drop the graph, its memory pool and the static buffers; the
        gradients, which live in the pool, go with it."""
        if self.graph is not None:
            self.optimizer.zero_grad(set_to_none=True)
            self.graph.reset()
        self.graph = self.static_in = self.static_out = None

    # -- capture -----------------------------------------------------------
    def _snapshot(self):
        """Clones of what a step changes: parameters, buffers, optimizer
        state, and the states of both generators."""
        device = self.generator.device
        tensors = [t.detach().clone() for t in self._model_tensors()]
        opt = {p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
               for p, st in self.optimizer.state.items()}
        return (tensors, opt, self.generator.get_state(),
                torch.cuda.get_rng_state(device))

    def _restore(self, snap):
        tensors, opt, gen, default = snap
        with torch.no_grad():
            for t, v in zip(self._model_tensors(), tensors):
                t.copy_(v)
            for p, st in self.optimizer.state.items():
                saved = opt.get(p)
                for k, v in st.items():
                    if not torch.is_tensor(v):
                        continue
                    if saved is None:  # made by the warm-up: Adam's zeros
                        v.zero_()
                    else:
                        v.copy_(saved[k])
        self.generator.set_state(gen)
        torch.cuda.set_rng_state(default, self.generator.device)

    def _model_tensors(self):
        return list(self.model.parameters()) + list(self.model.buffers())

    def _capture(self, batch):
        t0 = time.perf_counter()
        self.release()
        self.static_in = {k: v.clone() for k, v in batch.items()}
        snap = self._snapshot()
        side = torch.cuda.Stream(self.generator.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.body(self.static_in)
                self.traced += 1
        torch.cuda.current_stream().wait_stream(side)
        self._restore(snap)
        del snap
        # backward allocates the gradients from the graph's pool
        self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        # thread_local: the loader's threads may pin host memory, and its
        # placement stage launch kernels and allocate on its own stream,
        # while the step is captured
        with torch.cuda.graph(graph, capture_error_mode='thread_local'):
            out = self.body(self.static_in)
        self.traced += 1
        self.graph, self.static_out = graph, out
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
