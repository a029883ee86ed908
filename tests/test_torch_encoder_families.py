"""Every family of the port with each of the four encoders: build_model,
convert.py coverage, one forward; and one MoN step of the flagship
(PN-Transformer) with DGCNN and with PointNet++ SSG against the JAX package.

JAX pinned to f32, weights carried by convert.py, dropout off on both
sides; DGCNN's feature-space kNN graph is the port's, handed to JAX
(test_torch_encoders.py says why).  The MoN step is held by
torch_family_parity.assert_train_step_matches (loss and logs atol 1e-5,
rtol 1e-4; running statistics atol 1e-5, rtol 1e-4), its gradient limit
1e-4 relative L2 plus twice the port gradient's own movement under
relative 1e-7 and 1e-6 moves of the clouds with every kNN graph, FPS
sample and ball set held fixed: the train-mode PointNet++ gradient is
ill-conditioned (test_torch_encoders.py).

The MoN step's parts hold 600 points, more than PointNet++'s first FPS
takes (512).  With fewer, FPS repeats points, and the shared MLP's matmul
can round two identical rows differently by their position: the max-pool
then sends a gradient to one copy where the other implementation splits it
among all, and the two gradients differ by several percent.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

import torch_family_parity as U
from multi_part_assembly_tpu.models import build_model as jax_build_model
from multi_part_assembly_tpu.utils import config_utils as JCFG
from multi_part_assembly_tpu_torch.models import build_model
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG
from test_torch_encoders import ARCHS, _indices, _jax_knn_from, movement

torch.set_num_threads(2)

FLAGSHIP = ('configs/pn_transformer/pn_transformer/'
            'pn_transformer-32x1-cosine_400e-everyday.py')
FAMILY_CONFIGS = {'pn_transformer': FLAGSHIP, **U.CONFIGS}
ENCODER_FAMILIES = sorted(f for f in FAMILY_CONFIGS if f != 'identity')
# points a part: PointNet++'s widest ball takes 128; the MoN step's parts
# have more than its first FPS takes
N_FAM, N_MON = 128, 600


@pytest.fixture(scope='module', autouse=True)
def _f32_no_dropout():
    with U.jax_f32_no_dropout():
        yield


def _batch(seed, counts, n=N_FAM):
    """torch_family_parity.batch with n points a part."""
    b = U.batch(seed, counts)
    rng = np.random.RandomState(seed + 50)
    v = b['part_valids'][:, :, None, None]
    centres = rng.uniform(-0.4, 0.4, v.shape[:2] + (1, 3))
    b['part_pcs'] = ((centres + 0.1 * rng.randn(
        *v.shape[:2], n, 3)) * v).astype(np.float32)
    return b


def _cfgs(family, arch, n=N_FAM):
    """(JAX cfg, port cfg) of the family's everyday config, narrowed as
    torch_family_parity narrows it, with the encoder `arch`."""
    opts = U.NARROW[family] + ['data.max_num_part', str(U.P),
                               'data.num_pc_points', str(n),
                               'model.encoder', arch]
    path = os.path.join(U.ROOT, FAMILY_CONFIGS[family])
    jcfg = JCFG.load_cfg_file(path).merge_from_list(opts)
    tcfg = TCFG.load_cfg_file(path).merge_from_list(opts)
    tcfg.exp.bf16 = False
    if family == 'pn_transformer_refine':
        jcfg.model.transformer_pos_enc = tcfg.model.transformer_pos_enc = \
            (U.C, U.C)
    return jcfg, tcfg


def _rngs():
    return {'params': jax.random.PRNGKey(0),
            'dropout': jax.random.PRNGKey(1),
            'noise': jax.random.PRNGKey(2)}


@pytest.mark.parametrize('arch', ARCHS)
@pytest.mark.parametrize('family', ENCODER_FAMILIES)
def test_every_family_builds_and_runs_with_each_encoder(family, arch):
    """build_model builds the family with the encoder, convert.py carries
    every one of its tensors from the JAX tree (shapes from
    jax.eval_shape), and one train-mode forward gives finite poses."""
    jcfg, tcfg = _cfgs(family, arch)
    net = build_model(tcfg, 'cpu')
    shapes = jax.eval_shape(
        lambda d: jax_build_model(jcfg).init(_rngs(), d, train=False),
        U.to_jax(_batch(0, U.COUNTS)))
    var = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                 shapes)
    sd = jax_to_state_dict(var, family)
    ours = net.state_dict()
    assert set(sd) == set(ours)
    for k, v in ours.items():
        assert sd[k].shape == v.shape, k
    with torch.no_grad():
        out = net.train()(U.to_torch(_batch(1, (2, ))))
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def test_identity_builds_with_every_encoder():
    for arch in ('pointnet', ) + ARCHS:
        cfg = TCFG.load_cfg_file(os.path.join(
            U.ROOT, U.CONFIGS['identity'])).merge_from_list(
                ['model.encoder', arch])
        assert list(build_model(cfg, 'cpu').state_dict()) == ['dummy']


def test_unknown_encoder_raises():
    _, tcfg = _cfgs('pn_transformer', 'nosuch')
    with pytest.raises(NotImplementedError, match='nosuch'):
        build_model(tcfg, 'cpu')


def _mon_movement(net, b, tcfg, base, given):
    """test_torch_encoders.movement of the MoN gradient when the clouds
    move by a relative 1e-7 and 1e-6, the port's indices `given`."""
    d = np.random.RandomState(99).randn(*b['part_pcs'].shape)
    moved = []
    for eps in (1e-7, 1e-6):
        nb = dict(b)
        nb['part_pcs'] = (b['part_pcs'] * (1 + eps * d)).astype(np.float32)
        with _indices(**given):
            moved.append(U.torch_mon_step(copy.deepcopy(net), nb,
                                          tcfg)['grads'])
    return movement(base, moved)


@pytest.mark.parametrize('arch', ['dgcnn', 'pointnet2_ssg'])
def test_pn_transformer_mon_step_matches_jax(arch):
    """One train-mode MoN step of the flagship with the encoder: loss, logs,
    every gradient and every running statistic against JAX."""
    jcfg, tcfg = _cfgs('pn_transformer', arch, N_MON)
    model = jax_build_model(jcfg)
    b = _batch(2, (3, ), N_MON)
    var = jax.jit(lambda d: model.init(_rngs(), d, train=False))(
        U.to_jax(b))
    var = U.randomize_stats(
        {k: jax.tree_util.tree_map(np.asarray, dict(v))
         for k, v in var.items()}, 7)
    net = U.torch_no_dropout(build_model(tcfg, 'cpu'))
    net.load_state_dict(jax_to_state_dict(var, 'pn_transformer'),
                        strict=True)
    with _indices(record=True) as (knn_calls, sampling):
        ours = U.torch_mon_step(copy.deepcopy(net), b, tcfg)
        given = dict(graph=list(knn_calls), fps=list(sampling['fps']),
                     ball=list(sampling['ball']))
    movement = _mon_movement(net, b, tcfg, ours['grads'], given)
    with _jax_knn_from(given['graph']):
        ref = U.jax_mon_step(model, var, b, jcfg)
    U.assert_train_step_matches(ours, ref, var, 'pn_transformer',
                                grad_tol=1e-4 + 2 * movement)


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    import sys
    sys.path.insert(0, os.path.join(U.ROOT, 'scripts'))
    from make_synthetic_data import generate
    root = tmp_path_factory.mktemp('enc')
    os.environ['MPA_MESH_CACHE_DIR'] = str(root / 'mesh_cache')
    return generate(str(root / 'data'), n_shapes=4, min_parts=2,
                    max_parts=4, seed=0)


@pytest.mark.parametrize('arch', ['dgcnn', 'pointnet2_ssg'])
def test_flagship_trains_on_cpu_with_each_encoder(arch, synth, tmp_path):
    """scripts/train_torch.py on the flagship config with the encoder at a
    tiny size: one epoch of two steps, a validation and a checkpoint (MSG
    runs SSG's code with three scales, and takes 30 s here)."""
    import train_torch
    first = train_torch.main([
        '--cfg_file', os.path.join(U.ROOT, FLAGSHIP), '--device', 'cpu',
        '--ckp_dir', str(tmp_path / 'run'), '--vis', '0', '--opts',
        'data.data_dir', synth, 'exp.num_epochs', '1', 'exp.val_every', '1',
        'exp.batch_size', '2', 'data.max_num_part', '4',
        'data.num_pc_points', '128', 'exp.bf16', 'False', 'model.encoder',
        arch, *U.NARROW['pn_transformer']])
    assert first.step == 2 and first.ckpt_mgr.all_steps() == [0]
    assert all(np.isfinite(v) for v in first.metrics.values())
