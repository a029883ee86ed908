"""Where the host wire's data wait comes from, on one CUDA card.

    python3 scripts/wire_study_torch.py [--runs 4] [--epochs 3]

Trains the flagship config at full width (batch 32, P=20, N=1000) on the
synthetic everyday set of chip_smoke.py, alternating the host wire
(data.device_sampling False) and the slot wire (True), `--runs` runs in
all.  Each run:
  1. `--epochs` epochs through the loader (its producer thread running),
     printing each step's time and the wait for its batch;
  2. as many steps on batches collated in advance, with no producer
     thread running;
  3. one epoch's `collate_batch` calls timed alone on the host.
Step 1's steps against step 2's show what the producer's work costs the
trainer; step 3 shows whether the producer can keep up with a step.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import FLAGSHIP_CFG, _make_everyday_set  # noqa: E402


def _mean(xs):
    return sum(xs) / len(xs)


def run(data_dir, ckp_dir, device_sampling, epochs):
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    cfg = load_cfg_file(FLAGSHIP_CFG)
    cfg.merge_from_list(['data.data_dir', data_dir,
                         'data.device_sampling', str(device_sampling)])
    cfg.freeze()
    trainer = Trainer(cfg, 'cuda', ckp_dir=ckp_dir)
    loader = trainer.train_loader

    for epoch in range(epochs):  # 1. through the loader
        trainer.train_epoch(epoch)
    with open(os.path.join(ckp_dir, 'metrics.jsonl')) as f:
        waits = [1000.0 * json.loads(line)['train/data_time'] for line in f]
    steps = [1000.0 * s for s in trainer.step_seconds]

    loader.set_epoch(epochs)  # 2. on batches collated in advance
    batches = list(loader) * epochs
    pre = []
    for batch in batches:
        t0 = time.perf_counter()
        trainer.train_step(batch)  # syncs on its logs
        pre.append(1000.0 * (time.perf_counter() - t0))

    ds, bs = loader.dataset, loader.batch_size  # 3. collates alone
    t0 = time.perf_counter()
    for i in range(len(loader)):
        ds.collate_batch(list(range(i * bs, (i + 1) * bs)))
    collate_ms = 1000.0 * (time.perf_counter() - t0) / len(loader)
    trainer.close()

    tag = f'device_sampling {device_sampling}'
    print(f'{tag}: loop steps {["%.1f" % s for s in steps]}', flush=True)
    print(f'{tag}: loop waits {["%.1f" % w for w in waits]}', flush=True)
    print(f'{tag}: steady loop step {_mean(steps[1:]):.2f} ms, wait '
          f'{_mean(waits[1:]):.2f} ms; pre-collated step {_mean(pre):.2f} ms '
          f'({len(pre)} steps); collate alone {collate_ms:.2f} ms/batch',
          flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--runs', type=int, default=4)
    parser.add_argument('--epochs', type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: this study runs only on a GPU')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f'host cores {os.cpu_count()}', flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ['MPA_MESH_CACHE_DIR'] = os.path.join(tmp, 'mesh_cache')
        data_dir = os.path.join(tmp, 'everyday')
        _make_everyday_set(data_dir)
        for i in range(args.runs):
            run(data_dir, os.path.join(tmp, f'run{i}'), i % 2 == 1,
                args.epochs)


if __name__ == '__main__':
    main()
