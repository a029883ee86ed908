"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic and limits are found by name from
BENCHMARK.json (benchmark/harness/spec.py).  The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the end-to-end metrics with --trace 0, the per-layer ones with --trace
1), `device`, with --trace 1 `breakdown`, and last `checks`, each number
that decided `correct` beside its limit; the same checks end standard
error.  The run fails, printing no result, without as many CUDA devices as
the cell asks for, or when JAX or the JAX package is loaded once the
window has closed.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, 'benchmark')
CACHE = os.path.join(BENCH, '.cache')


def _caches():
    """Build and kernel caches of the program at fixed paths inside the
    checkout; a library that would load JAX by itself is kept from it."""
    os.environ.setdefault('MPA_MESH_CACHE_DIR', os.path.join(CACHE, 'mesh'))
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(CACHE, 'triton'))
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          os.path.join(CACHE, 'torch_extensions'))
    os.environ['USE_FLAX'] = '0'


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import cell, guard, spec

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    workload, config, traffic, wfile = spec.cell(args.workload)
    need = int(workload['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f'{args.workload} needs {need} CUDA device(s); found '
            f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 2
    log(f'card: {cell.power_limit()}')
    out = cell.run(config, traffic, wfile['limits'],
                   spec.per_layer(args.workload), args.seed, args.seconds,
                   bool(args.trace), device='cuda', log=log)
    bad = guard.forbidden_modules()
    if bad:
        log(f'forbidden modules loaded: {", ".join(bad)}')
        return 3
    for k, c in out['checks'].items():
        log(f"{k} {c['value']:.6e} limit {c['limit']:.6e}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
