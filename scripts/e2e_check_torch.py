"""End-to-end convergence check of the PyTorch/CUDA port through its CLIs.

The port's counterpart of the `pn_transformer` row of scripts/e2e_check.py:
on a synthetic Breaking-Bad tree (8 shapes of 2-3 box pieces, the val split
the same shapes) it runs, each as a subprocess,

  1. scripts/train_torch.py until the last epoch, and requires the best
     val/part_acc to reach the threshold;
  2. checks that checkpoints were saved under <ckp_dir>/models/;
  3. scripts/train_torch.py again on the same ckp_dir with one more epoch,
     and requires its 'resumed from epoch' line;
  4. scripts/test_torch.py from the newest kept checkpoint, and requires
     its test/part_acc within 0.1 of the threshold.

    python scripts/e2e_check_torch.py [--device cuda|cpu] [--epochs N]
        [--threshold X] [--num_points N] [--workdir DIR] [--keep]
        [--extra_opts key value ...]

The recipe is scripts/e2e_check.py's: 3 parts at most, batch 8, 256 points,
val every quarter of the epochs, trans weight 10, MoN off, rot_range 0.5.
Rows for the other model families wait until the port has them.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, 'configs/pn_transformer/pn_transformer/'
                   'pn_transformer-32x1-cosine_400e-everyday.py')


def run(cmd, **kw):
    print('+', ' '.join(cmd), flush=True)
    return subprocess.run(cmd, check=True, cwd=REPO, **kw)


def read_metrics(ckp_dir):
    with open(os.path.join(ckp_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f if line.strip()]


def check(args, data_dir, work):
    """Train, check the checkpoints, resume, test; returns the result."""
    ckp_dir = os.path.join(work, 'ckp')
    opts = [
        'data.data_dir', data_dir,
        'data.num_pc_points', str(args.num_points),
        'data.max_num_part', '3',
        'exp.batch_size', '8',
        'exp.num_epochs', str(args.epochs),
        'exp.val_every', str(max(1, args.epochs // 4)),
        'exp.num_workers', '0',
        'loss.trans_loss_w', '10.',
        'loss.sample_iter', '1',
        'data.rot_range', '0.5',
        'exp.ckp_dir', os.path.join(work, 'cli_tmp'),
    ] + list(args.extra_opts)
    train = [sys.executable, 'scripts/train_torch.py', '--cfg_file', CFG,
             '--device', args.device, '--ckp_dir', ckp_dir]
    times = {}

    t0 = time.perf_counter()
    run(train + ['--opts'] + opts)
    times['train'] = time.perf_counter() - t0
    accs = [m['val/part_acc'] for m in read_metrics(ckp_dir)
            if 'val/part_acc' in m]
    assert accs, 'no validation records logged'
    best = max(accs)
    print(f'[pn_transformer] val/part_acc curve: '
          f'{[round(a, 3) for a in accs]}', flush=True)
    result = {'model': 'pn_transformer', 'device': args.device,
              'best_val_part_acc': best, 'threshold': args.threshold}
    if best < args.threshold:
        return {**result, 'ok': False, 'seconds': times}

    model_dir = os.path.join(ckp_dir, 'models')
    steps = sorted(int(d) for d in os.listdir(model_dir) if d.isdigit())
    assert steps, 'no checkpoints saved'

    t0 = time.perf_counter()
    out = run(train + ['--opts'] + opts +
              ['exp.num_epochs', str(args.epochs + 1)],
              capture_output=True, text=True)
    times['resume'] = time.perf_counter() - t0
    resumed = [ln for ln in out.stdout.splitlines()
               if 'resumed from epoch' in ln]
    assert resumed, f'auto-resume not detected:\n{out.stdout[-2000:]}'
    print(resumed[0], flush=True)

    t0 = time.perf_counter()
    out = run([sys.executable, 'scripts/test_torch.py', '--cfg_file', CFG,
               '--device', args.device,
               '--weight', os.path.join(model_dir, str(steps[-1])),
               '--opts'] + opts, capture_output=True, text=True)
    times['test'] = time.perf_counter() - t0
    line = [ln for ln in out.stdout.splitlines() if 'test/part_acc' in ln]
    assert line, f'test_torch.py printed no part_acc:\n{out.stdout[-2000:]}'
    test_acc = float(line[-1].split('test/part_acc:')[1].split(';')[0])
    print(f'[pn_transformer] best val {best:.3f} | test {test_acc:.3f}',
          flush=True)
    return {**result, 'checkpoints': steps, 'resume_line': resumed[0],
            'test_part_acc': test_acc, 'seconds': times,
            'ok': bool(best >= args.threshold and
                       test_acc >= args.threshold - 0.1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--workdir', default='')
    ap.add_argument('--epochs', type=int, default=400)
    ap.add_argument('--threshold', type=float, default=0.9)
    ap.add_argument('--num_points', type=int, default=256)
    ap.add_argument('--keep', action='store_true')
    ap.add_argument('--extra_opts', nargs='*', default=[],
                    help='extra config overrides for every run')
    args = ap.parse_args(argv)

    work = args.workdir or tempfile.mkdtemp(prefix='mpa_e2e_torch_')
    os.makedirs(work, exist_ok=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from make_synthetic_data import generate
    t0 = time.perf_counter()
    try:
        data_dir = os.path.join(work, 'data')
        generate(data_dir, n_shapes=8, min_parts=2, max_parts=3, seed=1)
        result = check(args, data_dir, work)
    finally:
        if not args.keep:
            shutil.rmtree(work, ignore_errors=True)
    result['wall_seconds'] = time.perf_counter() - t0
    print('RESULT ' + json.dumps(result), flush=True)
    if not result['ok']:
        raise SystemExit('E2E CHECK FAILED')
    print('E2E CHECK PASSED')
    return result


if __name__ == '__main__':
    main()
