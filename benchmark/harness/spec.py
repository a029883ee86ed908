"""A cell and the files it is made of, found by name.

BENCHMARK.json (the repository's root) names each cell's configuration and
traffic; `configs/<config>.json` holds the configuration as it is run (the
sections exp, data, optimizer, model and loss, beside its source, the keys
reduced and the sizes assumed), `traffic/<traffic>.json` the data set and
the data wire, `workloads/<cell>.json` the limits of its correctness
check.  A cell's set is generated on its first run into
`.cache/data/<kind>-<key>` under the benchmark's folder, `key` a hash of
the data parameters, and reused by later runs; cells of one data set share
it.
"""

import hashlib
import json
import os
import shutil

from . import synth

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(BENCH_DIR, '.cache')
SECTIONS = ('exp', 'data', 'optimizer', 'model', 'loss')


def _load(path):
    with open(path) as f:
        return json.load(f)


def benchmark_json(root=ROOT):
    return _load(os.path.join(root, 'BENCHMARK.json'))


def cell(name, root=ROOT):
    """(workload entry, config file, traffic file, workload file) of a cell
    named in BENCHMARK.json."""
    spec = benchmark_json(root)
    entries = [w for w in spec['workloads'] if w['name'] == name]
    if not entries:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    w = entries[0]
    def load(folder, stem):
        return _load(os.path.join(BENCH_DIR, folder, f'{stem}.json'))
    return (w, load('configs', w['config']), load('traffic', w['traffic']),
            load('workloads', name))


def per_layer(name, root=ROOT):
    """The per-layer metrics a cell reports: those that list it, and those
    without a list that move an end-to-end metric the cell reports."""
    spec = benchmark_json(root)
    reported = {m['name'] for m in spec['end_to_end']
                if name in m.get('workloads', [name])}
    return [m for m in spec['per_layer']
            if (name in m['workloads'] if 'workloads' in m
                else m['moves'] in reported)]


def data_key(traffic):
    blob = json.dumps(traffic['data'], sort_keys=True).encode()
    return f"{traffic['data']['kind']}-{hashlib.sha1(blob).hexdigest()[:12]}"


def ensure_data(traffic, cache=CACHE):
    """The data directory of a traffic file, generated on first use: into
    `<dir>.part`, renamed to `<dir>` when whole."""
    d = traffic['data']
    path = os.path.join(cache, 'data', data_key(traffic))
    if os.path.isdir(path):
        return path
    part = path + '.part'
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    if d['kind'] == 'geometry':
        synth.build_everyday(part, d['n_train'], d['n_val'], d['part_pool'],
                             d['detail'], d['seed'])
    elif d['kind'] == 'partnet':
        synth.build_partnet(part, d['n_train'], d['n_val'], d['min_parts'],
                            d['max_parts'], d['num_points'], d['seed'],
                            d['prefix'])
    else:
        raise ValueError(f"unknown data kind {d['kind']!r}")
    os.rename(part, path)
    return path


def run_config(config, traffic, data_dir, seed):
    """The config of a run as plain dicts: the config file's sections, the
    traffic's data options, the data directory and the seed."""
    cfg = {k: json.loads(json.dumps(config[k])) for k in SECTIONS}
    cfg['data'].update(traffic.get('options', {}))
    cfg['data']['data_dir'] = data_dir
    cfg['exp']['seed'] = int(seed)
    return cfg
