"""The port's training slice as a whole, held against the JAX package.

One train step on the same converted weights and the same batch: the
augmentation's rotations are injected on the torch side (recovered from
JAX's `part_quat`, their inverse), dropout is off on both sides, both
compute in f32.  Compared: the augmented batch (atol 1e-5), the
`mon_loss` total and parts (atol 1e-5, rtol 1e-4), every parameter
gradient (atol 1e-4, rtol 1e-3), the BN running stats (atol 1e-6), and
the update of one Adam step at lr 1e-3 (atol 2e-5, 2% of the step).
Adam's first step moves each parameter by lr * g / (|g| + 1e-8), so it
turns float noise in a gradient element near zero into a step of up to
lr: elements whose gradient is below 1e-6 are only held to |step| <= lr.
The same step through the unfused chamfer route (fused mode 'off') gives
the loss of the fused route within 1e-6 and its gradients within atol
1e-5, rtol 1e-4 (the two backwards sum a witness's terms in another order,
and the network carries that rounding on).
Plus the host data path: the dataset, the loader and a tiny CPU run of
scripts/train_torch.py.
"""

import os
import sys

import flax.linen as fnn
import flax.linen.attention as fattn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_part_assembly_tpu.datasets.geometry import (
    GeometryPartDataset as JaxGeometryPartDataset, augment_geometry_batch as
    jax_augment)
from multi_part_assembly_tpu.models import build_model as jax_build_model
from multi_part_assembly_tpu.train.core import mon_loss as jax_mon_loss
from multi_part_assembly_tpu.train.state import \
    build_optimizer as jax_build_optimizer
from multi_part_assembly_tpu.utils import config_utils as JCFG
from multi_part_assembly_tpu.utils import precision
from multi_part_assembly_tpu_torch.datasets import (DataLoader,
                                                    GeometryPartDataset,
                                                    augment_geometry_batch)
from multi_part_assembly_tpu_torch.models import build_model
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.ops import chamfer as TC
from multi_part_assembly_tpu_torch.train.core import mon_loss
from multi_part_assembly_tpu_torch.train.state import build_optimizer
from multi_part_assembly_tpu_torch.utils import config_utils as TCFG
from multi_part_assembly_tpu_torch.utils.rotation import quaternion_invert

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'scripts'))
FLAGSHIP = os.path.join(ROOT, 'configs/pn_transformer/pn_transformer/'
                        'pn_transformer-32x1-cosine_400e-everyday.py')
B, P, N = 3, 6, 32
# the flagship config, narrowed; no warmup so step 0 runs at the full lr
OPTS = ['model.pc_feat_dim', '16', 'model.transformer_feat_dim', '32',
        'model.transformer_heads', '4', 'model.transformer_layers', '2',
        'data.max_num_part', str(P), 'data.num_pc_points', str(N),
        'optimizer.warmup_ratio', '0.0', 'exp.num_epochs', '4']


@pytest.fixture(scope='module')
def no_dropout_f32():
    """f32 compute and no dropout in the JAX model (flax Dropout and the
    attention-weight dropout; positional argument 6 is dropout_rate)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, '__call__', lambda self, x, *a, **kw: x)
        weights = fattn.dot_product_attention_weights
        mp.setattr(fattn, 'dot_product_attention_weights',
                   lambda *a, **kw: weights(*a[:6], 0.0, *a[7:], **kw))
        prev = precision.compute_dtype()
        precision.set_compute_dtype(jnp.float32)
        yield
        precision.set_compute_dtype(prev)


def _raw_batch(seed=0):
    rng = np.random.RandomState(seed)
    valids = (np.arange(P)[None] <
              np.asarray([2, 6, 4])[:, None]).astype(np.float32)
    centres = rng.uniform(-0.4, 0.4, (B, P, 1, 3))
    raw = (centres + 0.1 * rng.randn(B, P, N, 3)).astype(np.float32)
    return raw * valids[:, :, None, None], valids


def _jax_step(raw, valids):
    cfg = JCFG.load_cfg_file(FLAGSHIP).merge_from_list(OPTS)
    model = jax_build_model(cfg)
    aug = jax_augment(jnp.asarray(raw), jnp.asarray(valids),
                      jax.random.PRNGKey(5))
    data = {**aug, 'part_valids': jnp.asarray(valids),
            'part_label': jnp.zeros((B, P, 0)),
            'instance_label': jnp.zeros((B, P, 0))}
    var = jax.jit(lambda r, d: model.init(r, d, train=True))(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1),
         'noise': jax.random.PRNGKey(2)}, data)
    params, stats = var['params'], var['batch_stats']

    def loss_fn(p):
        loss, logs, new_stats = jax_mon_loss(
            model, p, stats, data, jax.random.PRNGKey(3), cfg=cfg,
            training=True)
        return loss, (logs, new_stats)

    (_, (logs, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx, _ = jax_build_optimizer(cfg, 1, params)
    new_params = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(aug=to_np(aug), logs=to_np(logs),
                var=to_np({'params': params, 'batch_stats': stats}),
                grads=to_np(grads), new_stats=to_np(new_stats),
                new_params=to_np(new_params))


def _torch_step(raw, valids, ref):
    """The port's step on the weights of `_jax_step`'s result `ref`, with
    its rotations injected."""
    cfg = TCFG.load_cfg_file(FLAGSHIP).merge_from_list(OPTS)
    cfg.exp.bf16 = False
    net = build_model(cfg, 'cpu')
    net.load_state_dict(jax_to_state_dict(ref['var']), strict=True)
    for m in net.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    valids_t = torch.tensor(valids)
    quat = quaternion_invert(torch.tensor(ref['aug']['part_quat']))
    aug = augment_geometry_batch(torch.tensor(raw), valids_t, quat=quat)
    data = {**aug, 'part_valids': valids_t,
            'part_label': torch.zeros(B, P, 0),
            'instance_label': torch.zeros(B, P, 0)}
    net.train()
    loss, logs = mon_loss(net, data, cfg=cfg, training=True)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    opt, schedule = build_optimizer(cfg, 1, net)
    for group in opt.param_groups:
        group['lr'] = schedule(0)
    opt.step()
    return dict(aug=aug, logs=logs, grads=grads, net=net)


@pytest.fixture(scope='module')
def step(no_dropout_f32):
    raw, valids = _raw_batch()
    ref = _jax_step(raw, valids)
    return ref, _torch_step(raw, valids, ref)


def test_augmented_batch_matches_jax(step):
    ref, ours = step
    for k in ('part_pcs', 'part_quat', 'part_trans'):
        np.testing.assert_allclose(ours['aug'][k].numpy(), ref['aug'][k],
                                   atol=1e-5, rtol=0)


def test_mon_loss_matches_jax(step):
    ref, ours = step
    assert set(ours['logs']) == set(ref['logs'])
    for k, v in ref['logs'].items():
        np.testing.assert_allclose(float(ours['logs'][k].detach()), v,
                                   atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_gradients_match_jax(step):
    ref, ours = step
    ref_grads = jax_to_state_dict({'params': ref['grads'],
                                   'batch_stats': ref['var']['batch_stats']})
    for name, g in ours['grads'].items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_adam_step_and_bn_stats_match_jax(step):
    ref, ours = step
    before = jax_to_state_dict(ref['var'])
    after = jax_to_state_dict({'params': ref['new_params'],
                               'batch_stats': ref['new_stats']})
    grads = jax_to_state_dict({'params': ref['grads'],
                               'batch_stats': ref['var']['batch_stats']})
    for name, v in ours['net'].state_dict().items():
        if name not in ours['grads']:  # BN running stats
            np.testing.assert_allclose(v.numpy(), after[name].numpy(),
                                       atol=1e-6, rtol=1e-5, err_msg=name)
            continue
        ours_step = (v - before[name]).numpy()
        ref_step = (after[name] - before[name]).numpy()
        # elements with a gradient at float-noise level (the attention's
        # key bias has an exactly zero true gradient) only stay in bounds
        signal = np.abs(grads[name].numpy()) > 1e-6
        np.testing.assert_allclose(ours_step[signal], ref_step[signal],
                                   atol=2e-5, rtol=0, err_msg=name)
        assert np.abs(ours_step[~signal]).max(initial=0) <= 1e-3 + 1e-9


def test_unfused_route_step_matches_fused(step):
    """One step under fused mode 'off' (B8's plain version and the JAX
    unfused backward) against the same step under 'auto' (B1-B4's)."""
    ref, ours = step
    TC.set_fused_mode('off')
    try:
        off = _torch_step(*_raw_batch(), ref)
    finally:
        TC.set_fused_mode('auto')
    for k, v in ours['logs'].items():
        np.testing.assert_allclose(float(off['logs'][k].detach()),
                                   float(v.detach()), atol=1e-6, rtol=0,
                                   err_msg=k)
    for name, g in ours['grads'].items():
        np.testing.assert_allclose(off['grads'][name].numpy(), g.numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_weight_decay_mask_matches_jax(step):
    """AdamW decays the same parameters as the JAX optimizer's mask
    (utils/misc.py wd_param_mask): not biases, not norm layers."""
    from multi_part_assembly_tpu.utils.misc import wd_param_mask
    from multi_part_assembly_tpu_torch.train.state import decays
    ref, ours = step
    params = ref['var']['params']
    mask = jax.tree_util.tree_map(  # one flag per leaf -> leaf-shaped
        lambda m, p: np.full(np.shape(p), m, np.float32),
        wd_param_mask(params), params)
    mask = jax_to_state_dict({'params': mask,
                              'batch_stats': ref['var']['batch_stats']})
    for name, _ in ours['net'].named_parameters():
        assert bool(mask[name].all()) == bool(mask[name].any()), name
        assert decays(name) == bool(mask[name].all()), name


def test_augment_rot_range_bounds_angles():
    """rot_range > 0 draws bounded Euler angles from the generator; the GT
    quat undoes the rotation (JAX tests/test_datasets.py::
    test_augment_rot_range)."""
    from scipy.spatial.transform import Rotation as R
    raw, valids = _raw_batch(1)
    g = torch.Generator().manual_seed(0)
    out = augment_geometry_batch(torch.tensor(raw), torch.tensor(valids), g,
                                 rot_range=10.0)
    q = out['part_quat'].numpy()[valids > 0]
    angles = R.from_quat(np.c_[q[:, 1:], q[:, :1]]).as_euler(
        'xyz', degrees=True)
    assert np.all(np.abs(angles) < 11.0)
    np.testing.assert_allclose(out['part_pcs'].numpy().mean(2)[valids > 0],
                               0.0, atol=1e-5)


@pytest.fixture
def synth(tmp_path, monkeypatch):
    from make_synthetic_data import generate
    monkeypatch.setenv('MPA_MESH_CACHE_DIR', str(tmp_path / 'mesh_cache'))
    return generate(str(tmp_path / 'bb'), n_shapes=6, min_parts=2,
                    max_parts=5, seed=0)


def test_dataset_matches_jax(synth):
    kw = dict(data_dir=synth, data_fn='everyday.train.txt',
              data_keys=('part_ids', ), num_points=64, max_num_part=6)
    ours, ref = GeometryPartDataset(**kw), JaxGeometryPartDataset(**kw)
    assert ours.data_list == ref.data_list and len(ours) == 6
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ours)):
            a, b = ours[i], ref[i]
            for k in ('part_pcs_raw', 'part_valids', 'part_ids'):
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize('wire_dtype', ['float32', 'float16'])
def test_loader_batches(synth, wire_dtype):
    """The host wire ships the batch's K part rows in `wire_dtype` with the
    part counts; they expand to the dense f32 items' clouds, bit for bit on
    the f32 wire and on the f16 grid on the f16 wire, in the epoch's
    seeded order."""
    from multi_part_assembly_tpu_torch.datasets.geometry import \
        expand_geometry_batch
    ds = GeometryPartDataset(synth, 'everyday.train.txt', ('part_ids', ),
                             num_points=16, max_num_part=6,
                             wire_dtype=wire_dtype)
    loader = DataLoader(ds, batch_size=4, shuffle=True, drop_last=True)
    assert len(loader) == 1
    loader.set_epoch(1)
    batches = list(loader)
    assert len(batches) == 1
    b = batches[0]
    counts = [int((ds[i]['part_valids'] > 0).sum())
              for i in b['data_id'].tolist()]
    assert b['part_counts'].tolist() == counts
    assert b['part_pcs_raw__packed'].shape == (sum(counts), 16, 3)
    assert b['part_pcs_raw__packed'].dtype == getattr(torch, wire_dtype)
    pcs = expand_geometry_batch(b['part_pcs_raw__packed'],
                                b['part_counts'], 6)['part_pcs_raw']
    assert pcs.shape == (4, 6, 16, 3)
    assert pcs.dtype == torch.float32
    for row, i in enumerate(b['data_id'].tolist()):
        want = ds[i]['part_pcs_raw']
        if wire_dtype == 'float16':
            want = want.astype(np.float16).astype(np.float32)
        np.testing.assert_array_equal(pcs[row].numpy(), want)
    assert [b['data_id'].tolist() for b in loader] == \
        [batches[0]['data_id'].tolist()]  # shuffling is seeded by epoch
    val = DataLoader(ds, batch_size=4, shuffle=False, drop_last=False)
    assert [len(b['data_id']) for b in val] == [4, 2]


def test_train_script_runs_on_cpu(synth, tmp_path):
    """scripts/train_torch.py end to end at a tiny size on the CPU."""
    import train_torch
    trainer = train_torch.main([
        '--cfg_file', FLAGSHIP, '--ckp_dir', str(tmp_path / 'run'),
        '--device', 'cpu', '--no-bf16', '--opts', 'data.data_dir', synth,
        'exp.batch_size', '2',
        'exp.num_epochs', '2', 'exp.val_every', '1', *OPTS[:8],
        'data.num_pc_points', '16'])
    assert trainer.step == 6 and len(trainer.step_seconds) == 6
    assert 0.0 <= trainer.metrics['val/part_acc'] <= 1.0
    assert all(np.isfinite(v) for v in trainer.metrics.values())
    with open(tmp_path / 'run' / 'metrics.jsonl') as f:
        assert sum('train/loss' in line for line in f) == 6
