"""Testing entry point of the PyTorch/CUDA port.

Counterpart of scripts/test.py for `multi_part_assembly_tpu_torch`:
    python scripts/test_torch.py --cfg_file configs/...py --weight PATH \
        [--device cuda|cuda:N|cpu] [--category X | all] [--opts ...]

`--weight` takes a checkpoint step directory (`<run>/models/<epoch>`), the
state file in it, or a run directory, which resolves to its newest
checkpoint.  `--category all` tests every category with one Trainer, its
loaders swapped for each, and prints the LaTeX row of scripts/test.py
(rotations x1, translations x100, shape chamfer x1000, part accuracy
x100); it and any other `--category` apply to geometric configs only.
`--device` defaults to `cuda` and raises when CUDA is absent; the CPU runs
only when `--device cpu` asks for it.  A PartNet config reports part_acc
and connectivity_acc beside its losses.  Under torchrun each rank tests its
shard of the val split (`--device cuda`: its own card) and every rank
returns the all-reduced metrics, which rank 0 prints once.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

METRIC_ORDER = ['test/rot_rmse', 'test/rot_mae', 'test/trans_rmse',
                'test/trans_mae', 'test/transform_pt_cd_loss',
                'test/part_acc']
SCALE = {'test/rot_rmse': 1, 'test/rot_mae': 1, 'test/trans_rmse': 100,
         'test/trans_mae': 100, 'test/transform_pt_cd_loss': 1000,
         'test/part_acc': 100}


def resolve_weight(path):
    """A step directory or state file as it is; a run directory, or its
    models/, resolves to the newest checkpoint in it."""
    from multi_part_assembly_tpu_torch.train.checkpoint import find_last_ckp
    if not path or os.path.basename(path.rstrip('/')).isdigit() or \
            os.path.isfile(path):
        return path
    for cand in (path, os.path.dirname(path.rstrip('/'))):
        ckp = find_last_ckp(cand)
        if ckp:
            return ckp
    return path


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Testing script (torch)')
    parser.add_argument('--cfg_file', required=True, type=str)
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device: 'cuda', 'cuda:N' or 'cpu' "
                             "(default cuda; no CPU fallback)")
    parser.add_argument('--category', type=str, default='')
    parser.add_argument('--weight', type=str, default='')
    parser.add_argument('--opts', nargs='*', default=[],
                        help='config overrides: key value [key value ...]')
    parser.add_argument('--min_num_part', type=int, default=-1)
    parser.add_argument('--max_num_part', type=int, default=-1)
    return parser.parse_args(argv)


def _trainer(cfg, device):
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    return Trainer(cfg, device, ckp_dir=os.path.join(cfg.exp.ckp_dir,
                                                     '_test_tmp'),
                   resume=False, quiet=True)


def main(argv=None):
    """Test; returns the `test/*` metrics (one category) or a dict of lists,
    one value a category (`--category all`)."""
    from multi_part_assembly_tpu_torch.parallel import dist
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    args = parse_args(argv)
    device = dist.init_distributed(args.device)
    cfg = load_cfg_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.min_num_part > 0:
        cfg.data.min_num_part = args.min_num_part
    if args.max_num_part > 0:
        cfg.data.max_num_part = args.max_num_part
    if args.category and cfg.data.dataset != 'geometry':
        raise ValueError('--category applies to geometric configs only')

    if args.category != 'all':
        if args.category:
            cfg.data.category = args.category
        cfg.freeze()
        trainer = _trainer(cfg, device)
        weight = resolve_weight(args.weight)
        if weight:
            trainer.load_weights(weight)
        results = trainer.test()
        trainer.close()
        return results

    all_category = list(cfg.data.all_category)
    all_results = {}
    trainer = None
    for cat in all_category:
        cat_cfg = cfg.clone()
        cat_cfg.data.category = cat
        cat_cfg.freeze()
        weight = args.weight.format(cat) if '{}' in args.weight else \
            args.weight
        weight = resolve_weight(weight)
        if trainer is None:
            trainer = _trainer(cat_cfg, device)
        else:
            trainer.swap_loaders(cat_cfg)
        if weight:
            trainer.load_weights(weight)
        for k, v in trainer.test().items():
            all_results.setdefault(k, []).append(v)
    if trainer is not None:
        trainer.close()
    if dist.rank() == 0:  # every rank holds the all-reduced metrics
        print('categories:', all_category)
        rows = []
        for k in METRIC_ORDER:
            if k not in all_results:
                continue
            vals = np.asarray(all_results[k]) * SCALE[k]
            print(f'{k}: ' + ' '.join(f'{v:.2f}' for v in vals) +
                  f' | mean {vals.mean():.2f}')
            rows.append(f'{vals.mean():.2f}')
        print('LaTeX row: ' + ' & '.join(rows) + ' \\\\')
    return all_results


if __name__ == '__main__':
    from multi_part_assembly_tpu_torch.parallel import dist as _dist
    try:
        main()
    finally:
        _dist.destroy()
