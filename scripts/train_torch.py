"""Training entry point of the PyTorch/CUDA port.

Counterpart of scripts/train.py for `multi_part_assembly_tpu_torch`:
    python scripts/train_torch.py --cfg_file configs/...py \
        [--device cuda|cuda:N|cpu] [--opts key value ...] [--overfit N] \
        [--bf16 | --no-bf16]

Trains on `--device` (default `cuda`); a CUDA device that is absent is an
error, and the CPU runs only when `--device cpu` asks for it.  With
`--opts data.device_sampling True` (the default 'auto' is on for geometry
data on a CUDA device) the card samples the surface points itself from
resident mesh tables, laid out by `data.device_table_layout dense|chunked`
(default: the auto rule); `data.device_sampling False` samples them on the
host and copies the clouds.  Checkpoints and auto-resume are not ported
yet.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Training script (torch)')
    parser.add_argument('--cfg_file', required=True, type=str)
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device to train on: 'cuda', 'cuda:N' "
                             "or 'cpu' (default cuda; no CPU fallback)")
    parser.add_argument('--category', type=str, default='',
                        help='dataset category override')
    parser.add_argument('--opts', nargs='*', default=[],
                        help='config overrides: key value [key value ...]')
    parser.add_argument('--ckp_dir', type=str, default='')
    parser.add_argument('--overfit', type=int, default=-1)
    parser.add_argument('--bf16', action=argparse.BooleanOptionalAction,
                        default=None,
                        help='bf16 matmuls in the encoder, transformer and '
                             'regressor (default: cfg.exp.bf16, which '
                             'defaults to True; --no-bf16 forces f32)')
    return parser.parse_args(argv)


def build_cfg(args):
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    cfg = load_cfg_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.category:
        cfg.data.category = args.category
    if args.overfit > 0:
        cfg.data.overfit = args.overfit
    if args.bf16 is not None:
        cfg.exp.bf16 = args.bf16
    cfg_name = os.path.splitext(os.path.basename(args.cfg_file))[0]
    cfg.exp.ckp_dir = args.ckp_dir or os.path.join(
        cfg.exp.ckp_dir, cfg_name,
        cfg.data.category if cfg.data.category else 'all', 'models')
    cfg.freeze()
    return cfg


def main(argv=None):
    """Train; returns the Trainer (its last validation in .metrics)."""
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    args = parse_args(argv)
    cfg = build_cfg(args)
    print(cfg)
    trainer = Trainer(cfg, args.device, ckp_dir=cfg.exp.ckp_dir)
    for split, tables in trainer.tables.items():
        if tables is not None:
            print(f'{split}: device sampling, {tables.layout} tables of '
                  f'{tables.nbytes} bytes', flush=True)
    trainer.fit()
    trainer.close()
    print('Done training!')
    return trainer


if __name__ == '__main__':
    main()
