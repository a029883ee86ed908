"""One rank of tests/test_torch_multihost.py's two-rank gloo run on the
CPU: the port's counterpart of tests/multihost_worker.py.

    python tests/torch_multihost_worker.py --data_dir D --ckp_dir C \
        --out OUT.json --mode packed|slots|semantic

run under torchrun's variables (tests/torch_ddp_worker.py `spawn_ranks`
sets them).  Each rank trains the Global model (width 16) for one epoch
on its shard of the set (8 shapes -> 4 a rank -> one batch of 4), with a
validation and a rank-0 checkpoint; validates again; then a fresh
two-rank Trainer resumes from the checkpoint and validates.  `packed`
runs the host wire, `slots` the device-sampling slot wire (its plain
sampler on the CPU), `semantic` a partnet_chair-style set through
Hungarian matching (kernel L1's plain version).  Writes the metrics, the
parameter checksums and its checkpoint writes to OUT.json.

Not a pytest module itself.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'geometry': 'configs/global/global-32x1-cosine_200e-everyday.py',
    'semantic': 'configs/global/global-32x1-cosine_200e-partnet_chair.py',
}


def param_sum(model):
    """Exact (order-stable f64 host) parameter checksum."""
    return float(sum(np.abs(p.detach().double().numpy()).sum()
                     for p in model.parameters()))


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', required=True)
    p.add_argument('--ckp_dir', required=True)
    p.add_argument('--out', required=True)
    p.add_argument('--mode', default='packed',
                   choices=['packed', 'slots', 'semantic'])
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    torch.set_num_threads(2)
    from multi_part_assembly_tpu_torch.parallel import dist
    from multi_part_assembly_tpu_torch.train import checkpoint
    from multi_part_assembly_tpu_torch.train.trainer import (JSONLLogger,
                                                             Trainer)
    from multi_part_assembly_tpu_torch.utils import load_cfg_file

    device = dist.init_distributed('cpu')
    assert dist.world() == 2 and str(device) == 'cpu'
    semantic = args.mode == 'semantic'
    cfg = load_cfg_file(os.path.join(
        ROOT, CONFIGS['semantic' if semantic else 'geometry']))
    cfg.merge_from_list([
        'exp.batch_size', '4', 'exp.num_epochs', '1', 'exp.val_every', '1',
        'exp.seed', '0', 'exp.val_sample_vis', '1', 'exp.bf16', 'False',
        'data.data_dir', args.data_dir, 'data.num_pc_points', '24',
        'data.max_num_part', '4', 'model.pc_feat_dim', '16',
        'loss.noise_dim', '4'])
    if semantic:
        cfg.merge_from_list(['data.data_fn', 'Chair.{}.npy',
                             'data.device_table', 'True',
                             'loss.sample_iter', '2'])
    else:
        cfg.merge_from_list(['data.data_fn', 'everyday.{}.txt',
                             'data.device_sampling',
                             str(args.mode == 'slots')])
    cfg.freeze()

    writes = []  # files this rank wrote under models/
    save = torch.save

    def counted_save(obj, f, *a, **kw):
        if isinstance(f, str) and os.sep + 'models' + os.sep in f:
            writes.append(f)
        return save(obj, f, *a, **kw)

    checkpoint.torch.save = counted_save

    trainer = Trainer(cfg, 'cpu', ckp_dir=args.ckp_dir, resume=False,
                      quiet=True)
    # per-rank loader shard: 8 shapes -> 4 a rank -> 1 batch of 4
    assert trainer.train_loader.world == 2, trainer.train_loader.world
    assert trainer.train_loader.rank == dist.rank()
    assert len(trainer.train_loader) == 1, len(trainer.train_loader)
    assert isinstance(trainer.logger, JSONLLogger) == (dist.rank() == 0)
    if args.mode == 'slots':
        assert trainer.tables['train'] is not None
    elif semantic:
        assert trainer.part_tables['train'] is not None
    else:
        assert trainer.tables['train'] is None
    trainer.fit()  # 1 epoch: train step, validation, checkpoint
    metrics = trainer.validate(0)  # all-reduced across ranks
    sum_final = param_sum(trainer.model)
    trainer.close()

    trainer2 = Trainer(cfg, 'cpu', ckp_dir=args.ckp_dir, resume=True,
                       quiet=True)
    assert trainer2.start_epoch == 1, trainer2.start_epoch
    sum_resumed = param_sum(trainer2.model)
    resumed = trainer2.validate(0)
    trainer2.close()
    with open(args.out, 'w') as f:
        json.dump({
            'final': metrics, 'resumed': resumed,
            'param_sum_final': sum_final, 'param_sum_resumed': sum_resumed,
            'writes': writes, 'step': trainer.step,
        }, f)
    dist.barrier()
    dist.destroy()
    print(f'rank {dist.rank()}: OK', flush=True)


if __name__ == '__main__':
    main()
