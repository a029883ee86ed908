"""Training entry point of the PyTorch/CUDA port.

Counterpart of scripts/train.py for `multi_part_assembly_tpu_torch`:
    python scripts/train_torch.py --cfg_file configs/...py \
        [--device cuda|cuda:N|cpu] [--opts key value ...] [--overfit N] \
        [--bf16 | --no-bf16] [--ckp_dir DIR] [--weight CKPT] [--no_resume] \
        [--vis N] [--profile DIR]

Trains on `--device` (default `cuda`); a CUDA device that is absent is an
error, and the CPU runs only when `--device cpu` asks for it.  With
`--opts data.device_sampling True` (the default 'auto' is on for geometry
data on a CUDA device) the card samples the surface points itself from
resident mesh tables, laid out by `data.device_table_layout dense|chunked`
(default: the auto rule); `data.device_sampling False` samples them on the
host and copies the clouds.  A PartNet (semantic) config keeps its part
clouds in a resident f16 table on the card with `data.device_table True`
(the default 'auto' is on for PartNet data on a CUDA device); `False`
ships each batch's clouds as packed f16 rows.  `--category` applies to
geometric configs only.

Every validation saves a checkpoint under `<ckp_dir>/models/<epoch>/`,
keeping the 5 best by val/part_acc, and exports sampled assemblies as PLY
under `<ckp_dir>/vis/` (`--vis N` shapes; 0 turns it off).  A run started
on a `ckp_dir` that holds checkpoints resumes from the newest unless
`--no_resume`; `--weight` loads a checkpoint (its step directory or the
state file in it) when nothing was resumed.  The environment variable
MPA_SEED overrides `exp.seed`.  `--profile DIR` writes a torch.profiler
trace of one epoch (trained before the run proper, as scripts/train.py
does) to DIR/trace.json; scripts/profile_summary_torch.py summarises it.

Data parallelism: under torchrun (scripts/gpu_run.sh) every process is a
rank (multi_part_assembly_tpu_torch/parallel/dist.py); `--device cuda`
means each rank's own card, cuda:LOCAL_RANK, and `--device cpu` ranks
talk over gloo.  `exp.batch_size` is a rank's batch: D ranks train a
global batch of D x 32 under a `-32x1-` config.  `--opts exp.sync_bn
False` gives each rank its own batch-norm statistics.  Rank 0 alone
prints, logs and writes checkpoints.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Training script (torch)')
    parser.add_argument('--cfg_file', required=True, type=str)
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device to train on: 'cuda', 'cuda:N' "
                             "or 'cpu' (default cuda; no CPU fallback)")
    parser.add_argument('--category', type=str, default='',
                        help='dataset category override')
    parser.add_argument('--weight', type=str, default='',
                        help='load weights (auto-resume wins if checkpoints '
                             'exist)')
    parser.add_argument('--opts', nargs='*', default=[],
                        help='config overrides: key value [key value ...]')
    parser.add_argument('--ckp_dir', type=str, default='')
    parser.add_argument('--overfit', type=int, default=-1)
    parser.add_argument('--bf16', action=argparse.BooleanOptionalAction,
                        default=None,
                        help="bf16 matmuls in the model's encoder, "
                             'transformer, pair MLPs and pose heads '
                             '(default: cfg.exp.bf16, which defaults to '
                             'True; --no-bf16 forces f32)')
    parser.add_argument('--no_resume', action='store_true')
    parser.add_argument('--vis', type=int, default=-1,
                        help='samples to visualize per val epoch')
    parser.add_argument('--profile', type=str, default='',
                        help='write a torch.profiler trace of the first '
                             'epoch into this directory')
    return parser.parse_args(argv)


def build_cfg(args):
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    cfg = load_cfg_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.category:
        if cfg.data.dataset != 'geometry':
            raise ValueError('--category applies to geometric configs only')
        cfg.data.category = args.category
    if args.overfit > 0:
        cfg.data.overfit = args.overfit
    if args.bf16 is not None:
        cfg.exp.bf16 = args.bf16
    if args.vis >= 0:
        cfg.exp.val_sample_vis = args.vis
    if os.environ.get('MPA_SEED'):
        cfg.exp.seed = int(os.environ['MPA_SEED'])
    cfg_name = os.path.splitext(os.path.basename(args.cfg_file))[0]
    cfg.exp.ckp_dir = args.ckp_dir or os.path.join(
        cfg.exp.ckp_dir, cfg_name,
        cfg.data.category if cfg.data.category else 'all', 'models')
    cfg.freeze()
    return cfg


def profile_epoch(trainer, out_dir):
    """One epoch under torch.profiler, its trace in out_dir/trace.json
    and the program's spans and counters of the epoch (every thread's,
    utils/tracing.py) in out_dir/spans.json."""
    from torch.profiler import ProfilerActivity, profile

    from multi_part_assembly_tpu_torch.utils import tracing
    acts = [ProfilerActivity.CPU]
    if trainer.device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    t0, counts = time.time_ns(), tracing.counters()
    with profile(activities=acts) as prof:
        trainer.train_epoch(trainer.start_epoch)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, 'trace.json'))
    after = tracing.counters()
    with open(os.path.join(out_dir, 'spans.json'), 'w') as f:
        json.dump({'spans': [s.as_dict() for s in tracing.spans()
                             if s.start_ns >= t0],
                   'counters': {k: v - counts.get(k, 0)
                                for k, v in after.items()},
                   'max_num_part': int(trainer.cfg.data.max_num_part)}, f)
    print(f'profile trace written to {out_dir}', flush=True)


def main(argv=None):
    """Train; returns the Trainer (its last validation in .metrics)."""
    from multi_part_assembly_tpu_torch.parallel import dist
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    args = parse_args(argv)
    device = dist.init_distributed(args.device)
    cfg = build_cfg(args)
    lead = dist.rank() == 0
    if lead:
        print(cfg)
    trainer = Trainer(cfg, device, ckp_dir=cfg.exp.ckp_dir,
                      resume=not args.no_resume)
    if args.weight and trainer.start_epoch == 0:
        trainer.load_weights(args.weight)
    for split, tables in trainer.tables.items():
        if tables is not None and lead:
            print(f'{split}: device sampling, {tables.layout} tables of '
                  f'{tables.nbytes} bytes', flush=True)
    for split, table in trainer.part_tables.items():
        if table is not None and lead:
            print(f'{split}: resident part table of {table.nbytes} bytes',
                  flush=True)
    if args.profile:
        profile_epoch(trainer, args.profile)
    trainer.fit()
    trainer.close()
    if lead:
        print('Done training!')
    return trainer


if __name__ == '__main__':
    from multi_part_assembly_tpu_torch.parallel import dist as _dist
    try:
        main()
    finally:
        _dist.destroy()
