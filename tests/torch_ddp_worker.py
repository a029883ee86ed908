"""One rank of tests/test_torch_ddp.py's two-rank gloo run on the CPU, and
the launcher the port's data-parallel tests share (`spawn_ranks`).

    python tests/torch_ddp_worker.py --inputs IN.pt --out OUT.pt

run under torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), which `spawn_ranks` sets.  Each rank takes its
half of the global batches in IN.pt (rank r: rows [r*B/2, (r+1)*B/2)),
runs each case and saves what it saw to OUT.pt:

  - allreduce: `all_reduce_sum` forward and backward;
  - bn/<case>/<mode>: a train-mode MaskedBatchNorm forward and backward
    (masked, unmasked, lean masked, lean unmasked; sync and per-replica),
    weight and bias gradients summed over the ranks;
  - dgcnn: the DGCNN encoder, sync, forward and backward; dgcnn_stage: its
    first EdgeConv stage under per-replica mode, which stays sync;
  - step: one flagship `optimize_step` (the trainer's), f32, no dropout;
  - draws: the first normals of the rank's generator;
  - ckpt: an asynchronous save of the stepped model (rank 0 writes, its
    write held back 0.5 s), the model changed in place after it, then
    `wait_until_finished` and every rank's read of the checkpoint.

Not a pytest module itself.
"""

import argparse
import os
import socket
import subprocess
import sys
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def spawn_ranks(argv_of, world=2, timeout=300):
    """Run `python *argv_of(rank)` as `world` ranks on this host, each
    waited for at most `timeout` seconds (all killed on a timeout); any
    rank's failure raises with its output.  Returns the outputs."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                   OMP_NUM_THREADS='2')
        procs.append(subprocess.Popen(
            [sys.executable, *argv_of(r)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out.decode(errors='replace'))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f'rank {r} failed:\n{log[-6000:]}')
    return logs


def _half(t, r, world):
    n = t.shape[0] // world
    return t[r * n:(r + 1) * n]


def _bn_case(TN, dist, spec, x, mask, g, r, world, sync):
    """One train-mode MaskedBatchNorm forward and backward on this rank's
    half; parameter gradients summed over the ranks."""
    bn = TN.MaskedBatchNorm(x.shape[-1], lean=spec['lean'], sync=sync)
    with torch.no_grad():
        for name in ('weight', 'bias', 'running_mean', 'running_var'):
            getattr(bn, name).copy_(spec[name])
    bn.train()
    xl = _half(x, r, world).clone().requires_grad_(True)
    ml = None if mask is None else _half(mask, r, world)
    out = bn(xl, ml)
    (out * _half(g, r, world)).sum().backward()
    return {'out': out.detach(), 'dx': xl.grad,
            'dweight': dist.all_reduce_(bn.weight.grad.clone()),
            'dbias': dist.all_reduce_(bn.bias.grad.clone()),
            'running_mean': bn.running_mean.clone(),
            'running_var': bn.running_var.clone()}


def _async_save(folder, model, dist):
    """Save `model` asynchronously on every rank, change it in place while
    rank 0's write is held back, then wait and read the checkpoint back."""
    import time

    from multi_part_assembly_tpu_torch.train import checkpoint as CK
    real = CK.torch.save

    def slow_save(obj, path):
        time.sleep(0.5)
        real(obj, path)

    CK.torch.save = slow_save
    try:
        mgr = CK.CheckpointManager(folder)
        at_save = {k: v.clone() for k, v in model.state_dict().items()}
        t0 = time.perf_counter()
        mgr.save(0, {'model': model.state_dict()}, {'val/part_acc': 0.5})
        save_s = time.perf_counter() - t0
        on_disk_at_return = os.path.isdir(os.path.join(folder, '0'))
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        mgr.wait_until_finished()
    finally:
        CK.torch.save = real
    loaded = CK.load_state(os.path.join(folder, '0'), 'cpu')['model']
    return {'at_save': at_save, 'loaded': loaded, 'save_s': save_s,
            'on_disk_at_return': on_disk_at_return,
            'steps': mgr.all_steps(), 'writes': len(mgr.write_seconds)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--inputs', required=True)
    p.add_argument('--out', required=True)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    torch.set_num_threads(2)
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.models.modules import encoders as TE
    from multi_part_assembly_tpu_torch.models.modules import norm as TN
    from multi_part_assembly_tpu_torch.parallel import dist
    from multi_part_assembly_tpu_torch.train.state import build_optimizer
    from multi_part_assembly_tpu_torch.train.trainer import optimize_step
    from multi_part_assembly_tpu_torch.utils import config_utils as TCFG

    device = dist.init_distributed('cpu')
    r, world = dist.rank(), dist.world()
    assert world == int(os.environ['WORLD_SIZE']) > 1, world
    inp = torch.load(args.inputs, weights_only=False)
    res = {'rank': r, 'world': world, 'device': str(device)}

    # all_reduce_sum: y = sum_r c_r x_r; loss_r = sum(b_r y);
    # d x_r = c_r sum_r' b_r'
    x = torch.arange(4.0).requires_grad_(True)
    y = dist.all_reduce_sum(x * (r + 2))
    (y * (r + 1)).sum().backward()
    res['allreduce'] = {'y': y.detach(), 'dx': x.grad}

    for name, spec in inp['bn'].items():
        for sync in (True, False):
            res[f'bn/{name}/{"sync" if sync else "replica"}'] = _bn_case(
                TN, dist, spec, spec['x'], spec['mask'], spec['g'], r, world,
                sync)

    d = inp['dgcnn']
    net = TE.DGCNN(d['feat'], k=d['k'])
    net.load_state_dict(d['state'])
    net.train()
    xl = _half(d['x'], r, world).clone().requires_grad_(True)
    out = net(xl, _half(d['mask'], r, world))
    (out * _half(d['g'], r, world)).sum().backward()
    res['dgcnn'] = {
        'out': out.detach(), 'dx': xl.grad,
        'grads': {n: dist.all_reduce_(q.grad.clone())
                  for n, q in net.named_parameters()},
        'state': {n: b.clone() for n, b in net.named_buffers()}}
    net.load_state_dict(d['state'])
    for m in net.modules():
        if isinstance(m, TN.MaskedBatchNorm):
            m.sync = False
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        h = _half(d['x'], r, world)
        emask = _half(d['mask'], r, world)[:, None, None]
        stage = net._edge_stage(h, net.conv1[0].weight[:, :, 0, 0], net.bn1,
                                emask)
    res['dgcnn_stage'] = {
        'out': stage.detach(), 'running_mean': net.bn1.running_mean.clone(),
        'running_var': net.bn1.running_var.clone(),
        'warned': any('injected stats override' in str(w.message)
                      for w in seen)}

    s = inp['step']
    cfg = TCFG.load_cfg_file(os.path.join(ROOT, s['cfg'])).merge_from_list(
        list(s['opts']))
    cfg.exp.bf16 = False
    model = build_model(cfg, 'cpu')
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    model.load_state_dict(s['state'])
    dist.broadcast_module(model)
    opt, schedule = build_optimizer(cfg, 1, model)
    for group in opt.param_groups:
        group['lr'] = schedule(0)
    data = {k: _half(v, r, world) for k, v in s['data'].items()}
    logs = optimize_step(model, opt, cfg, data)
    res['step'] = {'logs': logs,
                   'grads': {n: q.grad.clone()
                             for n, q in model.named_parameters()},
                   'params': {n: q.detach().clone()
                              for n, q in model.named_parameters()},
                   'state': {n: b.clone() for n, b in model.named_buffers()}}

    gen = torch.Generator().manual_seed(dist.rank_seed(inp['seed']))
    res['draws'] = torch.randn(8, generator=gen)

    res['ckpt'] = _async_save(inp['ckpt'], model, dist)
    torch.save(res, args.out)
    dist.barrier()
    dist.destroy()
    print(f'rank {r}: OK', flush=True)


if __name__ == '__main__':
    main()
