"""Data parallelism: one process a rank, over `torch.distributed`.

Counterpart of multi_part_assembly_tpu/parallel/mesh.py, which shards the
batch over a device mesh and lets XLA insert the collectives.  Here every
rank holds a replica of the model and trains on its own shard of the data
(datasets/geometry.py `DataLoader`); the collectives are explicit:

- the parameters and buffers are broadcast from rank 0 at the start, as
  JAX replicates its state;
- train-mode batch norm all-reduces its moments (`all_reduce_sum`, whose
  backward all-reduces the cotangent, so that each rank's gradient carries
  the other ranks' terms);
- after the backward, one flat all-reduce averages the gradients
  (`average_gradients`), before clipping and Adam;
- the eval sums are all-reduced in f64, so every rank reports the same
  metrics.

The processes are launched by torchrun (scripts/gpu_run.sh), which sets
RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT.  Without WORLD_SIZE, or with one rank, nothing here starts a
process group and every function is the identity or a no-op.

Backend rule: NCCL when every rank of a host has a card of its own
(LOCAL_WORLD_SIZE <= the cards it sees), gloo when ranks share a card or
run on the CPU.  Under gloo a CUDA tensor is staged through host memory
for each collective (`all_reduce_`, `_broadcast_`), so the rule holds for
every collective without relying on gloo's own CUDA paths.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ['init_distributed', 'rank_device', 'rank', 'world', 'barrier',
           'rank_seed', 'broadcast_module', 'all_reduce_', 'all_reduce_sum',
           'average_gradients', 'destroy']


def _env_int(name, default):
    value = os.environ.get(name)
    return default if value in (None, '') else int(value)


def world():
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def rank():
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def barrier():
    if world() > 1:
        dist.barrier()


def _check_cuda(device):
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {str(device)!r} asked for, but no CUDA '
                           'device is available; pass the CPU explicitly')


def rank_device(device):
    """The device this rank trains on for a request of `device` ('cuda',
    'cuda:N' or 'cpu'): with several ranks a CUDA request means
    cuda:{LOCAL_RANK % cards}; with one rank the request itself.  A CUDA
    request without CUDA raises: there is no CPU fallback."""
    device = torch.device(device)
    _check_cuda(device)
    if device.type == 'cuda' and world() > 1:
        return torch.device('cuda', _env_int('LOCAL_RANK', rank()) %
                            torch.cuda.device_count())
    return device


def _backend(device):
    """NCCL when each rank of this host has a card of its own, else gloo
    (module docstring), with the reason."""
    if device.type != 'cuda':
        return 'gloo', 'CPU ranks'
    local = _env_int('LOCAL_WORLD_SIZE', _env_int('WORLD_SIZE', 1))
    cards = torch.cuda.device_count()
    if local <= cards:
        return 'nccl', f'{local} ranks on {cards} cards, one card a rank'
    return 'gloo', f'{local} ranks share {cards} card(s)'


def init_distributed(device='cuda'):
    """Join the process group that torchrun's environment describes (once)
    and return this rank's device (`rank_device`), made current.  With one
    rank (no WORLD_SIZE, or 1) it starts nothing and returns the request
    as is.  Rank 0 prints the backend the rule chose."""
    n = _env_int('WORLD_SIZE', 1)
    if n > 1 and world() == 1:
        device = torch.device(device)
        _check_cuda(device)
        backend, why = _backend(device)
        dist.init_process_group(backend, init_method='env://',
                                rank=_env_int('RANK', 0), world_size=n)
        if rank() == 0:
            print(f'distributed: {n} ranks, backend {backend} ({why})',
                  flush=True)
    device = rank_device(device)
    if device.type == 'cuda' and world() > 1:
        torch.cuda.set_device(device)
    return device


def destroy():
    """Leave the process group (at exit)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_seed(seed, r=None):
    """The seed of rank r's random stream: `seed` itself on rank 0 (a
    one-rank run keeps its stream), a 63-bit mix of (seed, r) elsewhere."""
    r = rank() if r is None else r
    if r == 0:
        return int(seed)
    state = np.random.SeedSequence([int(seed), int(r)]).generate_state(
        1, np.uint64)[0]
    return int(state) & (2**63 - 1)


def _staged(t):
    """Whether a collective on `t` goes through host memory (gloo and a
    CUDA tensor)."""
    return t.is_cuda and dist.get_backend() == 'gloo'


def all_reduce_(t):
    """Sum `t` over the ranks in place; returns it."""
    if world() == 1:
        return t
    if _staged(t):
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def _broadcast_(t):
    if _staged(t):
        host = t.cpu()
        dist.broadcast(host, src=0)
        t.copy_(host)
    else:
        dist.broadcast(t, src=0)


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the cotangent of x is the sum over ranks of
    the cotangents of y (each rank's loss depends on every rank's x)."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone())


def all_reduce_sum(x):
    """Sum of x over the ranks, differentiable; x itself with one rank."""
    if world() == 1:
        return x
    return _AllReduceSum.apply(x)


def broadcast_module(module):
    """Copy rank 0's parameters and buffers to every rank, one flat
    broadcast a dtype."""
    if world() == 1:
        return
    tensors = [t.data for t in module.parameters()] + list(module.buffers())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        _broadcast_(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def average_gradients(params):
    """Replace every gradient by its mean over the ranks: one flat
    all-reduce of all of them, in the profiler range `grad_all_reduce`.
    Every parameter must hold a gradient."""
    if world() == 1:
        return
    with torch.profiler.record_function('grad_all_reduce'):
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        all_reduce_(flat).div_(world())
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
