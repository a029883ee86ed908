"""End-to-end convergence check of the PyTorch/CUDA port through its CLIs.

The port's counterpart of the rows of scripts/e2e_check.py:43-113, with
their configs, epochs and thresholds: the geometry rows on a synthetic
Breaking-Bad tree (8 shapes of 2-3 box pieces), the semantic rows
(`*_partnet`) on a synthetic PartNet tree (`generate_partnet`: 8 shapes of
2-3 parts with equivalent duplicates, 256 points a part), the val split
the same shapes in both.  It runs, each as a subprocess,

  1. scripts/train_torch.py until the last epoch, and requires the best
     val/part_acc to reach the row's threshold;
  2. checks that checkpoints were saved under <ckp_dir>/models/;
  3. scripts/train_torch.py again on the same ckp_dir with one more epoch,
     and requires its 'resumed from epoch' line;
  4. scripts/test_torch.py from the newest kept checkpoint, and requires
     its test/part_acc within 0.1 of the threshold.

The `identity` row trains nothing: it runs scripts/test_torch.py alone and
reports the part accuracy of the identity pose, the reference's floor.

    python scripts/e2e_check_torch.py [--model NAME] [--device cuda|cpu]
        [--epochs N] [--threshold X] [--num_points N] [--workdir DIR]
        [--keep] [--extra_opts key value ...]

The recipe is scripts/e2e_check.py's: 3 parts at most, batch 8, 256 points,
val every quarter of the epochs, trans weight 10, MoN off (sample_iter 1)
except on the `_mon` row, which keeps the semantic recipe's sample_iter 5
and 32-d noise, and rot_range 0.5 on geometry rows only.
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
# the rows of scripts/e2e_check.py:43-113
FAMILIES = {
    'pn_transformer': dict(
        cfg='configs/pn_transformer/pn_transformer/'
            'pn_transformer-32x1-cosine_400e-everyday.py',
        epochs=400, threshold=0.9),
    'pn_transformer_refine': dict(
        cfg='configs/pn_transformer/pn_transformer_refine/'
            'pn_transformer_refine-32x1-cosine_400e-everyday.py',
        epochs=400, threshold=0.9),
    'global': dict(
        cfg='configs/global/global-32x1-cosine_200e-everyday.py',
        epochs=800, threshold=0.9),
    'lstm': dict(
        cfg='configs/lstm/lstm-32x1-cosine_200e-everyday.py',
        epochs=400, threshold=0.75),
    'dgl': dict(
        cfg='configs/dgl/dgl-32x1-cosine_200e-everyday.py',
        epochs=400, threshold=0.75),
    'rgl_net': dict(
        cfg='configs/rgl_net/rgl_net-32x1-cosine_200e-everyday.py',
        epochs=1600, threshold=0.75),
    'identity': dict(
        cfg='configs/identity/identity-32x1-cosine_200e-everyday.py',
        eval_only=True),
    'pn_transformer_partnet': dict(
        cfg='configs/pn_transformer/pn_transformer/'
            'pn_transformer-32x1-cosine_400e-partnet_chair.py',
        task='semantic', epochs=400, threshold=0.9),
    'pn_transformer_refine_partnet': dict(
        cfg='configs/pn_transformer/pn_transformer_refine/'
            'pn_transformer_refine-32x1-cosine_400e-partnet_chair.py',
        task='semantic', epochs=400, threshold=0.9),
    'global_partnet': dict(
        cfg='configs/global/global-32x1-cosine_200e-partnet_chair.py',
        task='semantic', epochs=800, threshold=0.9),
    'lstm_partnet': dict(
        cfg='configs/lstm/lstm-32x1-cosine_200e-partnet_chair.py',
        task='semantic', epochs=1000, threshold=0.75),
    'dgl_partnet': dict(
        cfg='configs/dgl/dgl-32x1-cosine_300e-partnet_chair.py',
        task='semantic', epochs=800, threshold=0.8),
    'rgl_net_partnet': dict(
        cfg='configs/rgl_net/rgl_net-32x1-cosine_300e-partnet_chair.py',
        task='semantic', epochs=3200, threshold=0.9),
    'pn_transformer_partnet_mon': dict(
        cfg='configs/pn_transformer/pn_transformer/'
            'pn_transformer-32x1-cosine_400e-partnet_chair.py',
        task='semantic', epochs=400, threshold=0.9, mon=True),
    'identity_partnet': dict(
        cfg='configs/identity/identity-32x1-cosine_200e-partnet_chair.py',
        task='semantic', eval_only=True),
}


def run(cmd, **kw):
    print('+', ' '.join(cmd), flush=True)
    return subprocess.run(cmd, check=True, cwd=REPO, **kw)


def read_metrics(ckp_dir):
    with open(os.path.join(ckp_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f if line.strip()]


def _test_part_acc(cmd):
    out = run(cmd, capture_output=True, text=True)
    line = [ln for ln in out.stdout.splitlines() if 'test/part_acc' in ln]
    assert line, f'test_torch.py printed no part_acc:\n{out.stdout[-2000:]}'
    return float(line[-1].split('test/part_acc:')[1].split(';')[0])


def check(args, data_dir, work):
    """Train, check the checkpoints, resume, test; returns the result."""
    name, spec = args.model, FAMILIES[args.model]
    cfg = os.path.join(REPO, spec['cfg'])
    epochs = args.epochs or spec.get('epochs', 400)
    threshold = args.threshold if args.threshold >= 0 else \
        spec.get('threshold', 0.9)
    ckp_dir = os.path.join(work, 'ckp')
    opts = [
        'data.data_dir', data_dir,
        'data.num_pc_points', str(args.num_points),
        'data.max_num_part', '3',
        'exp.batch_size', '8',
        'exp.num_epochs', str(epochs),
        'exp.val_every', str(max(1, epochs // 4)),
        'exp.num_workers', '0',
        'loss.trans_loss_w', '10.',
        'exp.ckp_dir', os.path.join(work, 'cli_tmp'),
    ]
    if not spec.get('mon'):
        opts += ['loss.sample_iter', '1']
    if spec.get('task') != 'semantic':
        opts += ['data.rot_range', '0.5']  # the partnet schema has none
    opts += list(args.extra_opts)
    test = [sys.executable, 'scripts/test_torch.py', '--cfg_file', cfg,
            '--device', args.device]
    result = {'model': name, 'device': args.device}
    times = {}

    if spec.get('eval_only'):
        # identity: nothing to train; the eval floor runs end to end
        t0 = time.perf_counter()
        acc = _test_part_acc(test + ['--opts'] + opts)
        times['test'] = time.perf_counter() - t0
        print(f'[{name}] eval-floor part_acc: {acc:.3f}', flush=True)
        return {**result, 'mode': 'eval_floor', 'test_part_acc': acc,
                'seconds': times, 'ok': True}

    train = [sys.executable, 'scripts/train_torch.py', '--cfg_file', cfg,
             '--device', args.device, '--ckp_dir', ckp_dir]
    t0 = time.perf_counter()
    run(train + ['--opts'] + opts)
    times['train'] = time.perf_counter() - t0
    accs = [m['val/part_acc'] for m in read_metrics(ckp_dir)
            if 'val/part_acc' in m]
    assert accs, 'no validation records logged'
    best = max(accs)
    print(f'[{name}] val/part_acc curve: {[round(a, 3) for a in accs]}',
          flush=True)
    result.update(best_val_part_acc=best, threshold=threshold, epochs=epochs)
    if best < threshold:
        return {**result, 'ok': False, 'seconds': times}

    model_dir = os.path.join(ckp_dir, 'models')
    steps = sorted(int(d) for d in os.listdir(model_dir) if d.isdigit())
    assert steps, 'no checkpoints saved'

    t0 = time.perf_counter()
    out = run(train + ['--opts'] + opts + ['exp.num_epochs', str(epochs + 1)],
              capture_output=True, text=True)
    times['resume'] = time.perf_counter() - t0
    resumed = [ln for ln in out.stdout.splitlines()
               if 'resumed from epoch' in ln]
    assert resumed, f'auto-resume not detected:\n{out.stdout[-2000:]}'
    print(resumed[0], flush=True)

    t0 = time.perf_counter()
    test_acc = _test_part_acc(
        test + ['--weight', os.path.join(model_dir, str(steps[-1])),
                '--opts'] + opts)
    times['test'] = time.perf_counter() - t0
    print(f'[{name}] best val {best:.3f} | test {test_acc:.3f}', flush=True)
    return {**result, 'checkpoints': steps, 'resume_line': resumed[0],
            'test_part_acc': test_acc, 'seconds': times,
            'ok': bool(best >= threshold and test_acc >= threshold - 0.1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--model', default='pn_transformer',
                    choices=sorted(FAMILIES))
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--workdir', default='')
    ap.add_argument('--epochs', type=int, default=0,
                    help="override the row's epoch budget")
    ap.add_argument('--threshold', type=float, default=-1.0,
                    help="override the row's part_acc threshold")
    ap.add_argument('--num_points', type=int, default=256)
    ap.add_argument('--keep', action='store_true')
    ap.add_argument('--extra_opts', nargs='*', default=[],
                    help='extra config overrides for every run')
    args = ap.parse_args(argv)

    work = args.workdir or tempfile.mkdtemp(prefix='mpa_e2e_torch_')
    os.makedirs(work, exist_ok=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from make_synthetic_data import generate, generate_partnet
    t0 = time.perf_counter()
    try:
        data_dir = os.path.join(work, 'data')
        if FAMILIES[args.model].get('task') == 'semantic':
            generate_partnet(data_dir, n_shapes=8, min_parts=2, max_parts=3,
                             num_points=args.num_points, seed=1,
                             split_prefix='Chair.')
        else:
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
