"""Visualisation with the PyTorch port: rank the val samples by the
quality of their prediction and export the best as meshes and point
clouds.  Counterpart of scripts/vis.py (JAX-jitted forward):

    python scripts/vis_torch.py --cfg_file configs/...py --weight CKPT \
        [--device cuda|cpu] [--vis 10] [--out_dir vis_out] [--opts ...]

As the reference's scripts/vis.py: the criterion is rot_pt_l2_loss +
trans_mae, best first; for each part the original mesh, the mesh in its
input pose (the inverse of the GT pose) and in the predicted pose, with
clouds sampled from each, and coloured clouds of the whole assembly
(input, GT, prediction).  Meshes are read, written and sampled with the
port's own mesh_io and utils.  PartNet data has no meshes: clouds only.
The val batches are augmented, and the model's noise drawn, from a
generator seeded by the number of samples seen, as scripts/vis.py keys
them.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Visualization (torch)')
    parser.add_argument('--cfg_file', required=True, type=str)
    parser.add_argument('--weight', type=str, default='')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda', 'cuda:N' or 'cpu' (default cuda; no "
                             'CPU fallback)')
    parser.add_argument('--opts', nargs='*', default=[],
                        help='config overrides: key value [key value ...]')
    parser.add_argument('--category', type=str, default='')
    parser.add_argument('--min_num_part', type=int, default=-1)
    parser.add_argument('--max_num_part', type=int, default=-1)
    parser.add_argument('--vis', type=int, default=10,
                        help='number of shapes to export')
    parser.add_argument('--out_dir', type=str, default='vis_out')
    return parser.parse_args(argv)


def predict(trainer, cfg):
    """One eval-mode forward over the val set: a record and a criterion a
    sample."""
    from multi_part_assembly_tpu_torch.utils import (Rotation3D,
                                                     rot_points_l2_loss,
                                                     trans_metrics)
    rot_type = cfg.model.rot_type
    model = trainer.model
    model.eval()
    records, crits = [], []
    with torch.no_grad():
        for batch in trainer.val_loader:
            ids = batch.get('data_id')
            gen = torch.Generator(device=trainer.device).manual_seed(
                len(records))
            data = trainer._augment(batch, gen)
            gt_rot = Rotation3D(data['part_quat'], 'quat').convert(rot_type)
            data['part_rot_raw'] = gt_rot.rot
            pred = model(data, gen)
            rot, trans = pred['rot'], pred['trans']
            if trans.dim() == 4:  # a multi-step model: its last step
                rot, trans = rot[-1], trans[-1]
            pred_rot = Rotation3D(rot, rot_type)
            valids = data['part_valids']
            # the reference's cherry-pick criterion (vis.py:41)
            crit = rot_points_l2_loss(data['part_pcs'], pred_rot, gt_rot,
                                      valids) + \
                trans_metrics(trans, data['part_trans'], valids, 'mae')
            out = {'pred_trans': trans, 'pred_quat':
                   pred_rot.convert('quat').rot, 'gt_trans':
                   data['part_trans'], 'gt_quat': data['part_quat'],
                   'pred_rot_raw': rot, 'part_pcs': data['part_pcs'],
                   'part_valids': valids}
            out = {k: v.float().cpu().numpy() for k, v in out.items()}
            for b in range(valids.shape[0]):
                rec = {k: v[b] for k, v in out.items()}
                rec['data_id'] = -1 if ids is None else int(ids[b])
                records.append(rec)
                crits.append(float(crit[b]))
    return records, np.asarray(crits)


def main(argv=None):
    """Export the best `--vis` samples; returns their directories."""
    args = parse_args(argv)
    from multi_part_assembly_tpu_torch.datasets.mesh_io import (
        load_obj_numpy, sample_surface_numpy)
    from multi_part_assembly_tpu_torch.train.trainer import Trainer
    from multi_part_assembly_tpu_torch.utils import (Rotation3D,
                                                     load_cfg_file,
                                                     transform_pc)
    from multi_part_assembly_tpu_torch.utils.misc import (apply_pmat,
                                                          colorize_part_pc,
                                                          save_obj, save_pc)
    from multi_part_assembly_tpu_torch.utils.transforms import (
        quaternion_to_rmat, trans_quat_to_pmat, trans_rmat_to_pmat)

    cfg = load_cfg_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.category:
        cfg.data.category = args.category
    if args.min_num_part > 0:
        cfg.data.min_num_part = args.min_num_part
    if args.max_num_part > 0:
        cfg.data.max_num_part = args.max_num_part
    cfg.freeze()

    trainer = Trainer(cfg, args.device,
                      ckp_dir=os.path.join(args.out_dir, '_tmp'),
                      resume=False, quiet=True)
    if args.weight:
        trainer.load_weights(args.weight)
    rot_type = cfg.model.rot_type
    colors = np.asarray(cfg.data.colors)
    records, crits = predict(trainer, cfg)
    trainer.close()

    top_idx = np.argsort(crits, kind='stable')[:args.vis]  # best first
    dataset = trainer.val_loader.dataset
    is_geometry = cfg.data.dataset == 'geometry'
    save_dir = os.path.join(args.out_dir, args.category or 'all')
    rng_np = np.random.default_rng(0)
    written = []
    for rank, idx in enumerate(top_idx):
        rec = records[idx]
        p = int(rec['part_valids'].sum())
        if is_geometry and rec['data_id'] >= 0:
            mesh_rel = dataset.data_list[rec['data_id']]
            mesh_dir = os.path.join(dataset.data_dir, mesh_rel)
            mesh_files = sorted(os.listdir(mesh_dir))
            if len(mesh_files) != p:
                raise ValueError(f'{mesh_rel}: {len(mesh_files)} meshes for '
                                 f'{p} parts')
            sub = f"rank{rank}-{p}pcs-{mesh_rel.split('/')[-1]}"
            cur = os.path.join(save_dir, mesh_rel.split('/')[-2], sub)
        else:  # PartNet: no meshes on disk; clouds only
            mesh_files = []
            cur = os.path.join(save_dir, f'rank{rank}-{p}pcs-id{idx}')
        os.makedirs(cur, exist_ok=True)
        written.append(cur)

        for i, mesh_file in enumerate(mesh_files):
            verts, faces = load_obj_numpy(os.path.join(mesh_dir, mesh_file))
            save_obj(verts, faces, os.path.join(cur, mesh_file))
            # input pose: R^T (mesh - T) (reference vis.py:80-86)
            gt_rmat = quaternion_to_rmat(rec['gt_quat'][i])
            init_pmat = trans_rmat_to_pmat(
                -(gt_rmat.T @ rec['gt_trans'][i]), gt_rmat.T)
            init_verts = apply_pmat(verts, init_pmat)
            save_obj(init_verts, faces,
                     os.path.join(cur, f'input_{mesh_file}'))
            save_pc(sample_surface_numpy(init_verts.astype(np.float32), faces,
                                         dataset.num_points, rng_np),
                    os.path.join(cur, f'input_{mesh_file[:-4]}.ply'))
            # the predicted pose applied to the input mesh (vis.py:92-101)
            pred_verts = apply_pmat(init_verts, trans_quat_to_pmat(
                rec['pred_trans'][i], rec['pred_quat'][i]))
            save_obj(pred_verts, faces,
                     os.path.join(cur, f'pred_{mesh_file}'))
            save_pc(sample_surface_numpy(pred_verts.astype(np.float32), faces,
                                         dataset.num_points, rng_np),
                    os.path.join(cur, f'pred_{mesh_file[:-4]}.ply'))

        # coloured whole-assembly clouds (input, GT, prediction)
        pcs = torch.from_numpy(rec['part_pcs'])
        pred_rot = Rotation3D(torch.from_numpy(rec['pred_rot_raw']),
                              rot_type)
        gt_rot = Rotation3D(torch.from_numpy(rec['gt_quat']),
                            'quat').convert(rot_type)
        pred_pts = transform_pc(torch.from_numpy(rec['pred_trans']),
                                pred_rot, pcs).numpy()
        gt_pts = transform_pc(torch.from_numpy(rec['gt_trans']), gt_rot,
                              pcs).numpy()
        for tag, arr in (('pred', pred_pts), ('gt', gt_pts),
                         ('input', rec['part_pcs'])):
            pc = colorize_part_pc(arr[:p], colors).reshape(-1, 6)
            save_pc(pc, os.path.join(cur, f'assembly_{tag}.ply'))

    print(f'Saving {len(top_idx)} predictions for visualization to '
          f'{save_dir}...')
    return written


if __name__ == '__main__':
    main()
