"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure exits non-zero:
  1. device: refuse to run without CUDA; print torch/CUDA versions and the
     card's name and power limit (nvidia-smi);
  2. build: compile the port's CUDA kernels from csrc/*.cu;
  3. kernels: each chamfer kernel against its plain PyTorch version at the
     flagship shapes (B=32, P=20, N=1000), part counts drawn from the
     everyday mix: distances bit for bit, witnesses exactly, gradients
     within a stated tolerance; then both sampling kernels (dense, chunked)
     against their plain versions on the synthetic everyday set's tables
     and on a ragged set of triangle soups, at an everyday batch's row
     count and at the dense bound K = B*P: points bit for bit, face draws
     exactly, and dense equal to chunked; kernel and plain times from CUDA
     events;
  4. slice: one PN-Transformer MoN loss and its gradients on the card
     against the same step on the CPU (plain chamfer), same weights;
  5. main path: scripts/train_torch.py's main on the flagship config at
     full width on a synthetic everyday set, four runs of three epochs
     (12 steps of batch 32) and a validation each: the host wire
     (data.device_sampling False), the device-sampling wire with the auto
     table layout, with the dense layout, and the host wire again.  Each
     run resets the launch
     counters and requires its path's kernels to have launched in training
     and in validation.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'scripts'))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from multi_part_assembly_tpu_torch.datasets import \
    device_sampler as DS  # noqa: E402
from multi_part_assembly_tpu_torch.ops import chamfer as C  # noqa: E402
from multi_part_assembly_tpu_torch.ops import cuda_build  # noqa: E402

FLAGSHIP_CFG = os.path.join(
    ROOT, 'configs/pn_transformer/pn_transformer/'
    'pn_transformer-32x1-cosine_400e-everyday.py')
# everyday-like part-count mix of bench.py:125-126
PART_POOL = [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 10, 12, 16, 20]
B, P, N = 32, 20, 1000
DATA_KEYS = ('part_ids', 'valid_matrix')
CHAMFER_CU = 'multi_part_assembly_tpu_torch/csrc/chamfer.cu'
SAMPLER_CU = 'multi_part_assembly_tpu_torch/csrc/device_sampler.cu'
TPU = 'multi_part_assembly_tpu/ops/chamfer.py'
TPU_DS = 'multi_part_assembly_tpu/datasets/device_sampler.py'
# (name, launch counter, TPU kernel it replaces, source)
KERNELS = [
    ('chamfer_nn[parts]', 'nn_parts', f'{TPU}:483', CHAMFER_CU),
    ('chamfer_nn[diag]', 'nn_diag', f'{TPU}:556', CHAMFER_CU),
    ('chamfer_bwd[parts]', 'bwd_parts', f'{TPU}:632', CHAMFER_CU),
    ('chamfer_bwd[diag]', 'bwd_diag', f'{TPU}:687', CHAMFER_CU),
    ('sample_dense', 'sample_dense', f'{TPU_DS}:212', SAMPLER_CU),
    ('sample_chunked', 'sample_chunked', f'{TPU_DS}:269', SAMPLER_CU),
]
# face counts of the ragged soup set: sub-chunk, exactly one chunk, many
RAGGED_FACES = [37, 512, 3000, 20000]
# The backward's atomicAdds sum a witness's terms in a varying order, so
# its gradients match the plain index_add_ only to float rounding:
# |kernel - plain| <= GRAD_RTOL * max|plain| + GRAD_ATOL.
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: this smoke runs only on a GPU')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f'device: torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}, '
          f'{torch.cuda.device_count()} device(s)', flush=True)
    print(smi.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    cuda_build.load_library()
    print(f'build: {cuda_build.build_seconds():.2f} s '
          f'(nvcc {" ".join(cuda_build.NVCC_FLAGS)})', flush=True)


def _cuda_ms(fn, iters):
    """Mean device milliseconds of fn() over `iters` runs, by CUDA events.
    The runs queue up behind a device sleep of about 25 ms, so a kernel
    shorter than its own launch cost is timed on the device, not at the
    host's enqueue rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _call_ms(fn, iters):
    """Mean host milliseconds per call of fn(), synchronised at the end:
    what one call costs a caller that launches it once per step."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1000.0 * (time.perf_counter() - t0) / iters


def _clouds(counts, seed):
    """Two posed part clouds [B, P, N, 3]: each part a 0.1-scale cloud
    around a centre in [-0.4, 0.4]^3, the second a jittered copy."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    b = len(counts)
    centres = (torch.rand((b, P, 1, 3), generator=g, device='cuda') - 0.5) \
        * 0.8
    x = centres + 0.1 * torch.randn((b, P, N, 3), generator=g, device='cuda')
    y = x + 0.02 * torch.randn((b, P, N, 3), generator=g, device='cuda')
    valids = (torch.arange(P, device='cuda')[None] <
              torch.as_tensor(counts, device='cuda')[:, None]).float()
    x = x * valids[:, :, None, None]
    y = y * valids[:, :, None, None]
    return x.contiguous(), y.contiguous(), valids


def _check_pair(counts, seed, diagonal, timed):
    """One kernel pair against its plain version; returns (fwd, bwd) rows."""
    x, y, valids = _clouds(counts, seed)
    n_parts = valids.to(torch.int32).sum(1, dtype=torch.int32)

    def fwd(nn):
        return nn(x, y, n_parts, diagonal) + nn(y, x, n_parts, diagonal)

    d1k, w1k, d2k, w2k = fwd(C.nn_cuda)
    d1p, w1p, d2p, w2p = fwd(C.nn_plain)
    torch.cuda.synchronize()
    fwd_err = max(float((d1k - d1p).abs().max()),
                  float((d2k - d2p).abs().max()))
    mismatches = int((w1k != w1p).sum() + (w2k != w2p).sum())

    g = torch.Generator(device='cuda').manual_seed(seed + 1)
    g1 = torch.rand(d1k.shape, generator=g, device='cuda')
    g2 = torch.rand(d2k.shape, generator=g, device='cuda')

    def bwd(scatter):
        dx, dy = torch.zeros_like(x), torch.zeros_like(y)
        scatter(x, y, w1p, g1, dx, dy, diagonal=diagonal)
        scatter(y, x, w2p, g2, dy, dx, diagonal=diagonal)
        return dx, dy

    dxk, dyk = bwd(C.scatter_grad_cuda)
    dxp, dyp = bwd(C.scatter_grad_plain)
    torch.cuda.synchronize()
    bwd_err = max(float((dxk - dxp).abs().max()),
                  float((dyk - dyp).abs().max()))
    scale = max(float(dxp.abs().max()), float(dyp.abs().max()))
    bwd_tol = GRAD_RTOL * scale + GRAD_ATOL

    mode = 'diag' if diagonal else 'parts'
    tag = f'counts={sorted(counts, reverse=True)[:3]}.. B={len(counts)}'
    print(f'kernels: chamfer_nn[{mode}] {tag}: max|d kernel - d plain| = '
          f'{fwd_err:.3e} (bitwise required), witness mismatches = '
          f'{mismatches}', flush=True)
    print(f'kernels: chamfer_bwd[{mode}] {tag}: max|grad kernel - grad '
          f'plain| = {bwd_err:.3e} (tolerance {bwd_tol:.3e})', flush=True)
    if fwd_err != 0.0 or mismatches != 0:
        raise AssertionError(f'chamfer_nn[{mode}] disagrees with its plain '
                             'version')
    if not bwd_err <= bwd_tol:
        raise AssertionError(f'chamfer_bwd[{mode}] disagrees with its '
                             'plain version')
    if not timed:
        return None
    times = {
        'fwd': (_cuda_ms(lambda: fwd(C.nn_cuda), 20),
                _cuda_ms(lambda: fwd(C.nn_plain), 3)),
        'bwd': (_cuda_ms(lambda: bwd(C.scatter_grad_cuda), 20),
                _cuda_ms(lambda: bwd(C.scatter_grad_plain), 3)),
    }
    for kind, (k_ms, p_ms) in times.items():
        name = f'chamfer_{"nn" if kind == "fwd" else "bwd"}[{mode}]'
        print(f'kernels: {name} both directions: kernel {k_ms:.4f} ms, '
              f'plain {p_ms:.4f} ms', flush=True)
    return {'fwd': (fwd_err, *times['fwd']), 'bwd': (bwd_err, *times['bwd'])}


def phase_kernels():
    rng = np.random.default_rng(0)
    mix = rng.choice(PART_POOL, B)
    mix[0] = 20
    results = {}
    for diagonal in (False, True):
        mode = 'diag' if diagonal else 'parts'
        r = _check_pair(mix.tolist(), 1, diagonal, timed=True)
        results[f'nn_{mode}'] = r['fwd']
        results[f'bwd_{mode}'] = r['bwd']
        _check_pair([20] * 8, 2, diagonal, timed=False)
    return results


def _write_soups(folder):
    """Random triangle soups with the RAGGED_FACES face counts."""
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, nf in enumerate(RAGGED_FACES):
        v = np.random.default_rng(100 + i).normal(size=(nf * 3, 3))
        path = os.path.join(folder, f'soup{i}.obj')
        with open(path, 'w') as f:
            f.writelines(f'v {x:.6f} {y:.6f} {z:.6f}\n' for x, y, z in v)
            f.writelines(f'f {3 * j + 1} {3 * j + 2} {3 * j + 3}\n'
                         for j in range(nf))
        paths.append(path)
    return paths


def _check_sampler(name, tables, slots, seed):
    """Both sampling kernels against their plain versions on one slot
    array, and dense against chunked, then their times; returns
    {layout: (err, kernel ms, plain ms)}."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    u = torch.rand((slots.shape[0], 3, N), generator=g, device='cuda')
    out, tag = {}, f'{name} K={slots.shape[0]} N={N}'
    for layout, t in tables.items():
        pk, dk = DS._sample_points(t.table, t.n_faces, slots, u,
                                   return_draws=True)
        pp, dp = DS.sample_packed_ref(t.table, t.n_faces, slots, u,
                                      return_draws=True)
        torch.cuda.synchronize()
        err = float((pk - pp).abs().max())
        mismatches = int((dk != dp).sum())
        finite = bool(torch.isfinite(pk).all())
        out[layout] = [err, pk, dk]
        print(f'kernels: sample_{layout} {tag}: max|p kernel - p plain| = '
              f'{err:.3e} (bitwise required), draw mismatches = '
              f'{mismatches}', flush=True)
        if err != 0.0 or mismatches != 0 or not finite:
            raise AssertionError(f'sample_{layout} disagrees with its plain '
                                 f'version on {tag}')
    (_, pd, fd), (_, pc, fc) = out['dense'], out['chunked']
    # a chunked draw that took the alias triangle names f0 (as -1 - f0):
    # resolve it through the dense table's alias row
    f0 = torch.where(fc < 0, -1 - fc, fc).long()
    alias = tables['dense'].table[slots.long()[:, None], DS._ROW_ALIAS, f0]
    resolved = torch.where(fc < 0, (alias + 0.5).to(torch.int32), fc)
    same_faces = int((resolved != fd).sum())
    print(f'kernels: dense vs chunked {tag}: points bitwise equal '
          f'{torch.equal(pd, pc)}, face mismatches {same_faces}, alias '
          f'taken for {float((fc < 0).float().mean()):.3f} of the points',
          flush=True)
    if not torch.equal(pd, pc) or same_faces:
        raise AssertionError(f'dense and chunked kernels disagree on {tag}')
    result = {}
    for layout, t in tables.items():
        kern = DS.sample_chunked_cuda if layout == 'chunked' \
            else DS.sample_dense_cuda
        plain = DS.sample_chunked_plain if layout == 'chunked' \
            else DS.sample_dense_plain
        k_ms = _cuda_ms(lambda: kern(t.table, t.n_faces, slots, u), 100)
        p_ms = _cuda_ms(lambda: plain(t.table, t.n_faces, slots, u), 20)
        k_call = _call_ms(lambda: kern(t.table, t.n_faces, slots, u), 100)
        print(f'kernels: sample_{layout} {tag}: kernel {k_ms:.4f} ms on the '
              f'device ({k_call:.4f} ms per call by the host clock), plain '
              f'{p_ms:.4f} ms ({t.nbytes} table bytes)', flush=True)
        result[layout] = (out[layout][0], k_ms, p_ms)
    return result


def phase_sampler(data_dir, tmp):
    """B5/B6 on the everyday set's tables and on ragged soups, at an
    everyday batch's K and at the dense bound B*P."""
    from multi_part_assembly_tpu_torch.datasets import GeometryPartDataset
    ds = GeometryPartDataset(data_dir, 'everyday.train.txt', DATA_KEYS,
                             num_points=N, max_num_part=P)
    sets = {'everyday': (ds.all_mesh_paths(), ds.sampler),
            'ragged': (_write_soups(os.path.join(tmp, 'soups')),
                       ds.sampler)}
    rng = np.random.default_rng(5)
    results = None
    for name, (paths, sampler) in sets.items():
        tables = {}
        for layout in ('dense', 'chunked'):
            t0 = time.perf_counter()
            tables[layout] = DS.build_device_tables(paths, sampler, 'cuda',
                                                    layout=layout)
            torch.cuda.synchronize()
            print(f'kernels: {name} {layout} tables of {len(paths)} pieces '
                  f'built in {time.perf_counter() - t0:.2f} s', flush=True)
        if name == 'everyday':  # the slots of one real batch
            ds._device_tables = tables['dense']
            order = rng.permutation(len(ds))[:B].tolist()
            slots = ds.collate_batch(order)['part_slots__packed']
        else:  # as many rows, drawn over the ragged pieces
            slots = rng.integers(0, len(paths), len(slots))
        for i, rows in enumerate((slots, rng.integers(0, len(paths), B * P))):
            rows = torch.as_tensor(rows, dtype=torch.int32, device='cuda')
            r = _check_sampler(name, tables, rows, seed=10 + i)
            if name == 'everyday' and i == 0:
                results = {f'sample_{k}': v for k, v in r.items()}
    return results


def phase_slice():
    """MoN loss + gradients of one small flagship-width batch on the card
    (kernels) against the CPU (plain chamfer), same f32 weights."""
    from multi_part_assembly_tpu_torch.models import build_model
    from multi_part_assembly_tpu_torch.train.core import mon_loss
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    cfg = load_cfg_file(FLAGSHIP_CFG)
    cfg.exp.bf16 = False
    torch.manual_seed(0)
    model = build_model(cfg).train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    counts = [12, 5]
    x, _, valids = _clouds(counts, 3)
    g = torch.Generator(device='cuda').manual_seed(4)
    batch = {
        'part_pcs': x, 'part_valids': valids,
        'part_quat': torch.nn.functional.normalize(
            torch.randn((2, P, 4), generator=g, device='cuda'), dim=-1)
        * valids[..., None],
        'part_trans': 0.3 * torch.randn((2, P, 3), generator=g,
                                        device='cuda') * valids[..., None],
        'part_label': torch.zeros((2, P, 0), device='cuda'),
        'instance_label': torch.zeros((2, P, 0), device='cuda'),
    }
    out = {}
    for device in ('cpu', 'cuda'):
        m = model.to(device)
        m.zero_grad()
        loss, _ = mon_loss(m, {k: v.to(device) for k, v in batch.items()},
                           cfg=cfg, training=True)
        loss.backward()
        out[device] = (float(loss.detach()), torch.cat(
            [p.grad.reshape(-1).cpu() for p in m.parameters()]))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out['cpu'], out['cuda']
    rel_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    rel_grad = float((g_gpu - g_cpu).norm() / g_cpu.norm())
    print(f'slice: mon_loss card {l_gpu:.7f} vs CPU {l_cpu:.7f} (rel '
          f'{rel_loss:.2e}, tolerance 1e-4); gradient rel. L2 diff '
          f'{rel_grad:.2e} (tolerance 1e-3)', flush=True)
    if not (math.isfinite(l_gpu) and rel_loss <= 1e-4 and rel_grad <= 1e-3):
        raise AssertionError('the card disagrees with the CPU on one step')


def _make_everyday_set(root):
    """Synthetic everyday-format set: 128 shapes, part counts from the
    everyday mix (one with 20 parts), detail-8 box meshes."""
    from make_synthetic_data import generate
    rng = np.random.default_rng(0)
    counts = rng.choice(PART_POOL, 128)
    counts[0] = 20
    lines = []
    for i, n in enumerate(counts):
        generate(root, n_shapes=1, min_parts=int(n), max_parts=int(n),
                 seed=i, category=f'S{i:03d}', detail=8)
        lines.append(f'S{i:03d}/obj000')
    for split in ('train', 'val'):
        with open(os.path.join(root, f'everyday.{split}.txt'), 'w') as f:
            f.write('\n'.join(lines) + '\n')
    return int(counts.sum())


def _launches():
    return {**C.LAUNCHES, **DS.LAUNCHES}


# (label, extra --opts, table layout expected (None: the host wire), the
# sampling kernel that must launch).  On the 768-face boxes the auto rule
# picks chunked: dense scans 2 x 768 one-hot columns, chunked 2 x 512.
RUNS = [
    ('host wire', ['data.device_sampling', 'False'], None, None),
    ('device sampling, auto layout', ['data.device_sampling', 'True'],
     'chunked', 'sample_chunked'),
    ('device sampling, dense layout', ['data.device_sampling', 'True',
                                       'data.device_table_layout', 'dense'],
     'dense', 'sample_dense'),
    # last as well as first, so that an order effect shows
    ('host wire, again', ['data.device_sampling', 'False'], None, None),
]


def _train_run(index, data_dir, tmp):
    """One flagship run through train_torch.main: three epochs and a
    validation, every launch counter reset just before it."""
    import train_torch
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    label, opts, layout, sampler_key = RUNS[index]
    launches = {}
    validate = Trainer.validate

    def counted_validate(self, epoch):
        launches['train'] = _launches()
        metrics = validate(self, epoch)
        launches['val'] = {k: v - launches['train'][k]
                           for k, v in _launches().items()}
        return metrics

    run_dir = os.path.join(tmp, f'run{index}')
    Trainer.validate = counted_validate
    try:
        torch.cuda.reset_peak_memory_stats()
        C.reset_launches()
        DS.reset_launches()
        t0 = time.perf_counter()
        trainer = train_torch.main([
            '--cfg_file', FLAGSHIP_CFG, '--ckp_dir', run_dir,
            '--opts', 'data.data_dir', data_dir, 'exp.num_epochs', '3',
            'exp.val_every', '3', *opts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        totals = _launches()
    finally:
        Trainer.validate = validate
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    tag = f'main[{label}]'
    train = [r for r in records if 'train/loss' in r]
    losses = [r['train/loss'] for r in train]
    steps = trainer.step_seconds
    if len(steps) < 4:
        raise AssertionError(f'{tag}: expected >= 4 train steps, ran '
                             f'{len(steps)}')
    if not all(math.isfinite(v) for v in losses + list(
            trainer.metrics.values())):
        raise AssertionError(f'{tag}: non-finite loss: {losses} '
                             f'{trainer.metrics}')
    ms = 1000.0 * sum(steps[1:]) / len(steps[1:])
    waits = [1000.0 * r['train/data_time'] for r in train]
    wait_ms = sum(waits[1:]) / len(waits[1:])
    tables = trainer.tables['train']
    where = 'host-sampled clouds' if tables is None else \
        f'{tables.layout} tables of {tables.nbytes} bytes'
    print(f'{tag}: {where}; {len(steps)} train steps of batch {B}, first '
          f'{1000 * steps[0]:.1f} ms, then {ms:.2f} ms/step = '
          f'{B / (ms / 1000):.1f} samples/s; data wait {wait_ms:.3f} ms/step '
          f'(at most {max(waits[1:]):.1f}; first step {waits[0]:.1f} ms); '
          f'peak memory {peak_gib:.2f} GiB; wall {wall:.1f} s', flush=True)
    print(f'{tag}: train losses {["%.5f" % v for v in losses]}; val '
          f'part_acc {trainer.metrics["val/part_acc"]:.4f}, val loss '
          f'{trainer.metrics["val/loss"]:.5f}', flush=True)
    print(f'{tag}: kernel launches in training {launches["train"]}, in '
          f'validation {launches["val"]}', flush=True)

    if (None if tables is None else tables.layout) != layout or \
            (trainer.tables['val'] is None) != (layout is None):
        raise AssertionError(f'{tag}: expected the {layout or "host"} wire')
    for key in C.LAUNCHES:
        if launches['train'][key] <= 0:
            raise AssertionError(f'{tag}: {key} never launched in training')
    if launches['val']['nn_diag'] <= 0:
        raise AssertionError(f'{tag}: nn_diag never launched in validation')
    for key in DS.LAUNCHES:
        for split in ('train', 'val'):
            if (launches[split][key] > 0) != (key == sampler_key):
                raise AssertionError(
                    f'{tag}: {key} launched {launches[split][key]} times in '
                    f'{split}')
    return totals, (ms, wait_ms)


def phase_main(data_dir, tmp):
    totals, times = {}, []
    for index in range(len(RUNS)):
        launches, t = _train_run(index, data_dir, tmp)
        times.append(t)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    print('main: ' + '; '.join(
        f'{label} {ms:.2f} ms/step, data wait {wait:.3f} ms'
        for (label, *_), (ms, wait) in zip(RUNS, times)), flush=True)
    return totals


def main():
    phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        os.environ['MPA_MESH_CACHE_DIR'] = os.path.join(tmp, 'mesh_cache')
        data_dir = os.path.join(tmp, 'everyday')
        n_pieces = _make_everyday_set(data_dir)
        print(f'data: {n_pieces} pieces in 128 shapes (detail-8 boxes, '
              f'768 faces each)', flush=True)
        results = phase_kernels()
        results.update(phase_sampler(data_dir, tmp))
        phase_slice()
        launches = phase_main(data_dir, tmp)
    summary = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': source, 'replaces': rep,
         'launches': launches[key], 'max_abs_err': results[key][0],
         'ms': results[key][1], 'plain_ms': results[key][2]}
        for name, key, rep, source in KERNELS]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
