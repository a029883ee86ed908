"""A cell at a size a CPU test can hold: the cells' configurations with
small widths and points, and small synthetic sets of their kinds."""

import copy
import json
import os

from benchmark.harness import spec

LIMITS = os.path.join(spec.BENCH_DIR, 'workloads')


def config(name):
    with open(os.path.join(spec.BENCH_DIR, 'configs', f'{name}.json')) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg['model'].update(pc_feat_dim=16, transformer_feat_dim=32,
                        transformer_heads=2, transformer_layers=2)
    cfg['data'].update(num_pc_points=48, max_num_part=6)
    cfg['exp'].update(batch_size=4)
    return cfg


def traffic(name):
    with open(os.path.join(spec.BENCH_DIR, 'traffic', f'{name}.json')) as f:
        t = json.load(f)
    d = t['data']
    d.update(n_train=16, n_val=4)
    if d['kind'] == 'geometry':
        d.update(part_pool=[2, 3, 4, 6], detail=2)
    else:
        d.update(max_parts=6, num_points=48)
    return t


def limits(cell):
    with open(os.path.join(LIMITS, f'{cell}.json')) as f:
        return json.load(f)['limits']


CELLS = {
    'flagship-everyday-slot': ('pn_transformer-everyday', 'everyday_slot'),
    'semantic-chair-slot': ('pn_transformer-partnet_chair', 'chair_slot'),
    'flagship-everyday-host': ('pn_transformer-everyday', 'everyday_host'),
    'semantic-chair-host': ('pn_transformer-partnet_chair', 'chair_host'),
}
