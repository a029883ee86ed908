"""Aggregate test results over per-category and per-seed runs of the
PyTorch port (counterpart of scripts/collect_test.py, which builds the
JAX package's Trainer):

    python scripts/collect_test_torch.py --cfg_file configs/...py \
        --ckp_dirs RUN [RUN ...] [--category all | X] [--device cuda|cpu] \
        [--opts k v ...]

Each run directory (`{}` in it takes the category) is tested from its
newest checkpoint (`<run>/models/<epoch>`, the one train_torch.py wrote
last); duplicate seeds are averaged; the per-category rows and their mean
are printed as LaTeX, with scripts/collect_test.py's scales.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

METRIC_ORDER = ['test/rot_rmse', 'test/rot_mae', 'test/trans_rmse',
                'test/trans_mae', 'test/transform_pt_cd_loss',
                'test/part_acc', 'test/connectivity_acc']
SCALE = {'test/rot_rmse': 1, 'test/rot_mae': 1, 'test/trans_rmse': 100,
         'test/trans_mae': 100, 'test/transform_pt_cd_loss': 1000,
         'test/part_acc': 100, 'test/connectivity_acc': 100}


def main(argv=None):
    """Returns {category: {metric: mean over the runs}}."""
    parser = argparse.ArgumentParser(description='Collect test results')
    parser.add_argument('--cfg_file', required=True, type=str)
    parser.add_argument('--ckp_dirs', required=True, nargs='+',
                        help='run dirs; may contain {} for category')
    parser.add_argument('--category', type=str, default='all')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda', 'cuda:N' or 'cpu' (default cuda; no "
                             'CPU fallback)')
    parser.add_argument('--opts', nargs='*', default=[],
                        help='config overrides: key value [key value ...]')
    args = parser.parse_args(argv)

    from multi_part_assembly_tpu_torch.train.checkpoint import find_last_ckp
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    from multi_part_assembly_tpu_torch.utils import load_cfg_file

    cfg = load_cfg_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    categories = list(cfg.data.all_category) if args.category == 'all' \
        else [args.category]

    per_cat = {}
    for cat in categories:
        dup_results = []
        for ckp_dir in args.ckp_dirs:
            d = ckp_dir.format(cat) if '{}' in ckp_dir else ckp_dir
            ckp = find_last_ckp(d)
            if ckp is None:
                print(f'no checkpoint in {d}')
                continue
            cat_cfg = cfg.clone()
            cat_cfg.data.category = cat
            cat_cfg.freeze()
            trainer = Trainer(cat_cfg, args.device,
                              ckp_dir=os.path.join(d, '_collect_tmp'),
                              resume=False, quiet=True)
            trainer.load_weights(ckp)
            dup_results.append(trainer.test())
            trainer.close()
        if dup_results:
            per_cat[cat] = {k: float(np.mean([r[k] for r in dup_results]))
                            for k in dup_results[0]}

    if not per_cat:
        print('no results found')
        return per_cat
    keys = [k for k in METRIC_ORDER if k in next(iter(per_cat.values()))]
    print('category | ' + ' | '.join(keys))
    for cat, res in per_cat.items():
        row = ' & '.join(f'{res[k] * SCALE.get(k, 1):.2f}' for k in keys)
        print(f'{cat} & {row} \\\\')
    mean_row = ' & '.join(
        f'{np.mean([res[k] for res in per_cat.values()]) * SCALE.get(k, 1):.2f}'
        for k in keys)
    print(f'mean & {mean_row} \\\\')
    return per_cat


if __name__ == '__main__':
    main()
