"""Readings for the limits of a cell's correctness check: the program's
first steps, and the control and the planted faults, each put in the
program's place, against the plain reference, on the cell's own sizes.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--standins fp8,half,scaled] [--standin-seeds 3]

For each seed the program is set up as a run sets it up (cell.build: the
trainer, the seed's initial weights, epoch 0 with the checked steps) and
freed; the reference then follows the checked steps in the configuration's
compute type from the same weights; on the first `--standin-seeds` seeds
each stand-in follows them again: 'fp8' the control (rounded to e4m3
wherever the configuration rounds to bf16), 'half' the loss of
half the batch, 'scaled' the first part of every shape scaled by 0.5 where
its points are produced.  A step that leaves the state unchanged reads 1
on `change_gap`, and a backward scaled by k about |k - 1| on `grad_gap`,
by their definitions, and need no run.  One JSON line a seed and side,
with each leaf's first-gradient norms and each step's loss terms beside
the numbers, so that another number can be read from it.
The benchmark's runs never run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--standins', default='fp8,half,scaled')
    ap.add_argument('--standin-seeds', type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.run import _caches
    _caches()
    import torch

    from benchmark.harness import cell, compare, spec
    from benchmark.reference.loss import loss_weights
    from benchmark.reference.train import run_steps

    device = torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    _, config, traffic, _ = spec.cell(args.workload)
    standins = [s for s in args.standins.split(',') if s]
    for i, seed in enumerate(int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix='bench-')
        try:
            trainer, _, cfg, params0, prog = cell.build(
                config, traffic, seed, device, tmp)
            cell.free(trainer)
            del trainer
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        t1 = time.perf_counter()
        steps = len(prog['loss'])
        ref = run_steps(cfg, traffic['wire'], params0, seed, steps, device)
        t2 = time.perf_counter()
        sides = [('program', prog)]
        if i < args.standin_seeds:
            for standin in standins:
                kw = {'precision': 'fp8'} if standin == 'fp8' else \
                    {'fault': standin}
                sides.append((standin, run_steps(
                    cfg, traffic['wire'], params0, seed, steps, device,
                    **kw)))
        g_ref = compare._norms(ref['grad'])
        for name, side in sides:
            detail = {}
            values = compare.readings(side, ref, params0, loss_weights(cfg),
                                      detail)
            g = compare._norms(side['grad'])
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'side': name, 'steps': steps, **values,
                              'detail': detail,
                              'grad_norms': {n: [g[n], g_ref[n]]
                                             for n in g_ref},
                              'losses': [side['loss'], ref['loss']]}),
                  flush=True)
        print(f'seed {seed}: set-up {t1 - t0:.1f} s, reference '
              f'{t2 - t1:.1f} s, stand-ins {time.perf_counter() - t2:.1f} s',
              file=sys.stderr, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
