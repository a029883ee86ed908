"""The port's config loader against the JAX package's, and the port's
independence from JAX."""

import glob
import os
import subprocess
import sys

import pytest

from multi_part_assembly_tpu.utils import config_utils as JCFG
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, 'configs/pn_transformer/pn_transformer/'
                        'pn_transformer-32x1-cosine_400e-everyday.py')


def _composes_bases(path):
    with open(path) as f:
        return 'merge_cfg' in f.read()


# every leaf config of the tree (the ones that compose `_base_` files)
LEAVES = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, 'configs', '**', '*.py'),
                       recursive=True)
    if '_base_' not in p.split(os.sep) and _composes_bases(p))


def test_leaf_configs_found():
    assert os.path.relpath(FLAGSHIP, ROOT) in LEAVES


@pytest.mark.parametrize('cfg_file', LEAVES)
def test_loader_matches_jax(cfg_file):
    path = os.path.join(ROOT, cfg_file)
    ours = TCFG.cfg_to_dict(TCFG.load_cfg_file(path))
    ref = JCFG.cfg_to_dict(JCFG.load_cfg_file(path))
    assert ours == ref


def test_merge_from_list_matches_jax():
    opts = ['exp.num_epochs', '3', 'optimizer.lr', '0.01',
            'model.transformer_pre_ln', 'False', 'data.data_dir', '/x',
            'data.max_num_part', '12', 'data.device_sampling', 'False']
    ours = TCFG.load_cfg_file(FLAGSHIP).merge_from_list(opts)
    ref = JCFG.load_cfg_file(FLAGSHIP).merge_from_list(opts)
    assert TCFG.cfg_to_dict(ours) == JCFG.cfg_to_dict(ref)
    assert ours.exp.num_epochs == 3 and ours.model.transformer_pre_ln is False
    # a key the configs lack keeps the string, as in the JAX loader
    assert ours.data.device_sampling == 'False'


def test_frozen_cfg_refuses_writes():
    cfg = TCFG.load_cfg_file(FLAGSHIP)
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.exp.batch_size = 4
    cfg.defrost()
    cfg.exp.batch_size = 4
    assert cfg.clone().exp.batch_size == 4


_NO_JAX = f"""
import sys
sys.path.insert(0, {ROOT!r})
sys.path.insert(0, {os.path.join(ROOT, 'scripts')!r})
import torch
from multi_part_assembly_tpu_torch.models import build_model
from multi_part_assembly_tpu_torch.utils import load_cfg_file
import multi_part_assembly_tpu_torch.datasets
import multi_part_assembly_tpu_torch.train.trainer
import multi_part_assembly_tpu_torch.train.step
import multi_part_assembly_tpu_torch.train.checkpoint
import multi_part_assembly_tpu_torch.train.vis_utils
import multi_part_assembly_tpu_torch.utils.misc
import multi_part_assembly_tpu_torch.utils.eval_utils
import multi_part_assembly_tpu_torch.parallel
import multi_part_assembly_tpu_torch.parallel.dist
import train_torch, test_torch, e2e_check_torch
import print_cfg_torch, vis_torch, collect_test_torch, profile_summary_torch
from multi_part_assembly_tpu_torch.utils.rotation import Rotation3D
B, N = 2, 16
for rot_type, rot_dim in (('quat', 4), ('rmat', 6)):
    cfg = load_cfg_file({FLAGSHIP!r})
    cfg.merge_from_list(['model.pc_feat_dim', '16',
                         'model.transformer_feat_dim', '32',
                         'model.rot_type', rot_type])
    model = build_model(cfg, 'cpu').eval()
    P = cfg.data.max_num_part
    valids = (torch.arange(P)[None] < torch.tensor([[3], [5]])).float()
    with torch.no_grad():
        out = model({{'part_pcs': torch.randn(B, P, N, 3),
                     'part_valids': valids,
                     'part_label': torch.zeros(B, P, 0),
                     'instance_label': torch.zeros(B, P, 0)}})
    assert out['rot'].shape == (B, P, rot_dim), out['rot'].shape
    assert out['trans'].shape == (B, P, 3)
    assert torch.isfinite(Rotation3D(out['rot'], rot_type).to_euler()).all()
loaded = sorted(m for m in sys.modules if m.split('.')[0] in
                ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
                 'multi_part_assembly_tpu'))
assert not loaded, loaded
print('ok')
"""


def test_port_never_imports_jax():
    """A fresh interpreter imports the port (data parallelism and the
    compiled step too) and its scripts (the harness's too), loads the
    flagship config, builds the model with each pose head (quat and 6D)
    and runs one CPU forward without loading JAX, flax, optax, orbax or
    the JAX package."""
    proc = subprocess.run([sys.executable, '-c', _NO_JAX],
                          capture_output=True, text=True, timeout=240,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('ok')
