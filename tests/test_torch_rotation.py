"""The port's rotation math (utils/rotation.py, utils/transforms.py)
against the JAX package's, on the same numpy inputs.

Inputs: seeded random rotations plus exact poses (the identity, 90 and 180
degrees about each axis, and 180 degrees about the x+y diagonal, where two
of matrix_to_quaternion's candidates tie and the first must win).
Tolerance: atol 1e-5 on every conversion (f32 arithmetic; the closed forms
are the same expressions in the same order), 1e-6 on the pure products.
Euler angles: atol 1e-4 rad on random rotations; at the exact poses the
angles both sides define, which excludes those of a pose at +-90 degrees
pitch, whose other two angles are an atan2 of two zeros.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_part_assembly_tpu.utils import rotation as JR
from multi_part_assembly_tpu.utils import transforms as JT
from multi_part_assembly_tpu_torch.utils import rotation as TR
from multi_part_assembly_tpu_torch.utils import transforms as TT

torch.set_num_threads(2)

ORDERS = ('xyz', 'yzx', 'zxy', 'xzy', 'yxz', 'zyx')
# which Euler component each order takes from the arcsin
ASIN_AXIS = {'xyz': 1, 'yzx': 2, 'zxy': 0, 'xzy': 2, 'yxz': 0, 'zyx': 1}


def _unit(q):
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _exact_quats():
    """w-first quaternions of the exact poses."""
    h = math.sqrt(0.5)
    qs = [[1, 0, 0, 0]]
    for axis in range(3):
        for angle in (90, 180, -90):
            q = [math.cos(math.radians(angle) / 2), 0, 0, 0]
            q[1 + axis] = math.sin(math.radians(angle) / 2)
            qs.append(q)
    qs.append([0, h, h, 0])  # 180 about x+y: a tie of two candidates
    qs = np.asarray(qs, np.float64)
    # exact zeros where the sine or cosine is
    qs[np.abs(qs) < 1e-12] = 0.0
    return qs.astype(np.float32)


@pytest.fixture(scope='module')
def quats():
    rng = np.random.RandomState(0)
    random = _unit(rng.randn(64, 4))
    return {'random': random, 'exact': _exact_quats(),
            'all': np.concatenate([random, _exact_quats()])}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(jfn, tfn, *arrays):
    return (_np(jfn(*(jnp.asarray(a) for a in arrays))),
            _np(tfn(*(torch.tensor(a) for a in arrays))))


def test_quaternion_to_matrix(quats):
    ref, ours = _both(JR.quaternion_to_matrix, TR.quaternion_to_matrix,
                      quats['all'])
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_matrix_to_quaternion(quats):
    mats = _np(JR.quaternion_to_matrix(jnp.asarray(quats['all'])))
    ref, ours = _both(JR.matrix_to_quaternion, TR.matrix_to_quaternion, mats)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_matrix_to_quaternion_tie_takes_the_first():
    """180 degrees about x+y: |q_x| and |q_y| tie exactly; jnp.argmax and
    the port both take x's candidate, so the sign of the result agrees."""
    m = np.asarray([[0, 1, 0], [1, 0, 0], [0, 0, -1]], np.float32)
    q_abs = np.sqrt(np.maximum([1 + 0 + 0 - 1, 1 + 0 - 0 + 1,
                                1 - 0 + 0 + 1, 1 - 0 - 0 - 1], 0))
    assert q_abs[1] == q_abs[2]
    ref, ours = _both(JR.matrix_to_quaternion, TR.matrix_to_quaternion, m)
    np.testing.assert_array_equal(ours, ref)
    assert ours[1] > 0 and ours[2] > 0


def test_standardize_quaternion(quats):
    q = np.concatenate([quats['all'], -quats['all']])
    ref, ours = _both(JR.standardize_quaternion, TR.standardize_quaternion, q)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize('scale', [1.0, 1e-7, 0.0])
def test_axis_angle_round_trip(quats, scale):
    """Both directions, the Taylor branch below 1e-6 included (scale)."""
    rng = np.random.RandomState(1)
    aa = (scale * rng.randn(32, 3)).astype(np.float32)
    ref, ours = _both(JR.axis_angle_to_quaternion,
                      TR.axis_angle_to_quaternion, aa)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    ref, ours = _both(JR.axis_angle_to_matrix, TR.axis_angle_to_matrix, aa)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    q = quats['all'] if scale == 1.0 else _np(
        JR.axis_angle_to_quaternion(jnp.asarray(aa)))
    ref, ours = _both(JR.quaternion_to_axis_angle,
                      TR.quaternion_to_axis_angle, q)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    mats = _np(JR.quaternion_to_matrix(jnp.asarray(q)))
    ref, ours = _both(JR.matrix_to_axis_angle, TR.matrix_to_axis_angle, mats)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('scale', [1.0, 1e-8])
def test_rot6d_to_matrix(scale):
    """Gram-Schmidt of random 6D vectors; at scale 1e-8 the EPS floor."""
    rng = np.random.RandomState(2)
    d6 = (scale * rng.randn(32, 6)).astype(np.float32)
    ref, ours = _both(JR.rot6d_to_matrix, TR.rot6d_to_matrix, d6)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('order', ORDERS)
def test_qeuler_random(quats, order):
    for to_degree, atol in ((False, 1e-4), (True, 1e-4 * 180 / math.pi)):
        ref, ours = _both(
            lambda q: JR.qeuler(q, order, to_degree=to_degree),
            lambda q: TR.qeuler(q, order, to_degree=to_degree),
            quats['random'])
        np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


@pytest.mark.parametrize('order', ORDERS)
def test_qeuler_exact_poses(quats, order):
    ref, ours = _both(lambda q: JR.qeuler(q, order),
                      lambda q: TR.qeuler(q, order), quats['exact'])
    asin = ASIN_AXIS[order]
    # every pose's arcsin angle; the other two where the pose is not at
    # +-90 degrees pitch
    np.testing.assert_allclose(ours[:, asin], ref[:, asin], atol=1e-5)
    regular = np.abs(np.abs(ref[:, asin]) - math.pi / 2) > 1e-3
    assert regular.sum() >= 6
    np.testing.assert_allclose(ours[regular], ref[regular], atol=1e-5)


def test_qeuler_epsilon_and_bad_order(quats):
    ref, ours = _both(lambda q: JR.qeuler(q, 'zyx', epsilon=1e-3),
                      lambda q: TR.qeuler(q, 'zyx', epsilon=1e-3),
                      quats['random'])
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        TR.qeuler(torch.tensor(quats['random']), 'xxz')


ROT_INPUTS = ('quat', 'rmat', 'rot6d', 'rot6d_2x3', 'axis')


def _rot_input(kind, quats):
    rng = np.random.RandomState(3)
    q = quats['all'][:24].reshape(2, 12, 4)
    if kind == 'quat':
        q = q.copy()
        q[1, -3:] = 0.0  # padded parts: zero quats become the identity
        return q, 'quat'
    if kind == 'rmat':
        return _np(JR.quaternion_to_matrix(jnp.asarray(q))), 'rmat'
    if kind == 'axis':
        return _np(JR.quaternion_to_axis_angle(jnp.asarray(q))), 'axis'
    d6 = rng.randn(2, 12, 6).astype(np.float32)
    if kind == 'rot6d_2x3':
        return d6.reshape(2, 12, 2, 3), 'rmat'
    return d6, 'rmat'


@pytest.mark.parametrize('kind', ROT_INPUTS)
def test_rotation3d_conversions(quats, kind):
    """The constructor (6D input in both forms, padded quats), every
    conversion, to_euler, and apply_rotation."""
    raw, rot_type = _rot_input(kind, quats)
    jr = JR.Rotation3D(jnp.asarray(raw), rot_type)
    tr = TR.Rotation3D(torch.tensor(raw), rot_type)
    assert tr.rot_type == rot_type and tuple(tr.shape) == jr.shape
    np.testing.assert_allclose(_np(tr.rot), _np(jr.rot), atol=1e-6)
    for target in ('quat', 'rmat', 'axis'):
        np.testing.assert_allclose(_np(tr.convert(target).rot),
                                   _np(jr.convert(target).rot), atol=2e-5,
                                   err_msg=f'{rot_type} -> {target}')
    np.testing.assert_allclose(_np(tr.to_quat()), _np(jr.to_quat()),
                               atol=2e-5)
    np.testing.assert_allclose(_np(tr.to_rmat()), _np(jr.to_rmat()),
                               atol=2e-5)
    np.testing.assert_allclose(_np(tr.to_axis_angle()),
                               _np(jr.to_axis_angle()), atol=2e-5)
    if kind == 'rot6d':
        # random 6D rotations have no pose at +-90 degrees pitch
        np.testing.assert_allclose(_np(tr.to_euler()), _np(jr.to_euler()),
                                   atol=1e-3)
    if rot_type != 'axis':
        other_q = _unit(np.random.RandomState(4).randn(2, 12, 4))
        for other_type in ('quat', 'rmat'):
            jo = JR.Rotation3D(jnp.asarray(other_q), 'quat').convert(
                other_type)
            to = TR.Rotation3D(torch.tensor(other_q), 'quat').convert(
                other_type)
            np.testing.assert_allclose(_np(tr.apply_rotation(to).rot),
                                       _np(jr.apply_rotation(jo).rot),
                                       atol=2e-5)


def test_rotation3d_shape_ops(quats):
    q = quats['all'][:24].reshape(2, 12, 4)
    for rot_type in ('quat', 'rmat'):
        jr = JR.Rotation3D(jnp.asarray(q), 'quat').convert(rot_type)
        tr = TR.Rotation3D(torch.tensor(q), 'quat').convert(rot_type)
        pairs = [
            (tr.reshape(24, *tr.shape[2:]), jr.reshape(24, *jr.shape[2:])),
            (tr.reshape((4, 6) + tuple(tr.shape[2:])),
             jr.reshape((4, 6) + tuple(jr.shape[2:]))),
            (tr.unsqueeze(0), jr.unsqueeze(0)),
            (tr.unsqueeze(0).squeeze(0), jr.unsqueeze(0).squeeze(0)),
            (tr[1], jr[1]), (tr[:, 3:5], jr[:, 3:5]),
            (tr.detach(), jr.detach()), (tr.clone(), jr.clone()),
            (TR.Rotation3D.cat([tr, tr[:1]]),
             JR.Rotation3D.cat([jr, jr[:1]])),
            (TR.Rotation3D.cat([tr, tr], 1), JR.Rotation3D.cat([jr, jr], 1)),
            (TR.Rotation3D.stack([tr, tr]), JR.Rotation3D.stack([jr, jr])),
        ]
        for t, j in pairs:
            assert t.rot_type == j.rot_type == rot_type
            np.testing.assert_allclose(_np(t.rot), _np(j.rot), atol=1e-6)
        assert len(tr) == len(jr) == 2


def test_rotation3d_rejects_bad_input():
    with pytest.raises(ValueError):
        TR.Rotation3D(torch.zeros(3, 5), 'rmat')
    with pytest.raises(ValueError):
        TR.Rotation3D(torch.zeros(3, 3), 'quat')
    with pytest.raises(ValueError):
        TR.Rotation3D(torch.zeros(3, 4), 'euler')


@pytest.fixture(scope='module')
def poses():
    rng = np.random.RandomState(5)
    B, P, N = 2, 5, 16
    q = _unit(rng.randn(B, P, 4))
    return dict(q=q, r=_np(JR.quaternion_to_matrix(jnp.asarray(q))),
                t=(0.3 * rng.randn(B, P, 3)).astype(np.float32),
                v=rng.randn(B, P, N, 3).astype(np.float32),
                q2=_unit(rng.randn(B, P, 4)))


TRANSFORMS = [
    ('qmul', ('q', 'q2')), ('qrmat', ('q', )), ('rmatq', ('r', )),
    ('qrot', ('q', 'v')), ('qtransform', ('t', 'q', 'v')),
    ('qtransform_invert', ('t', 'q', 'v')), ('rmat_rot', ('r', 'v')),
    ('rmat_transform', ('t', 'r', 'v')),
]


@pytest.mark.parametrize('name,args', TRANSFORMS,
                         ids=[n for n, _ in TRANSFORMS])
def test_transforms(poses, name, args):
    ref, ours = _both(getattr(JT, name), getattr(TT, name),
                      *(poses[a] for a in args))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('rot_type', ['quat', 'rmat'])
def test_rot_pc_and_transform_pc(poses, rot_type):
    raw = poses['q'] if rot_type == 'quat' else poses['r']
    jr = JR.Rotation3D(jnp.asarray(raw), rot_type)
    tr = TR.Rotation3D(torch.tensor(raw), rot_type)
    v, t = poses['v'], poses['t']
    np.testing.assert_allclose(
        _np(TT.rot_pc(tr, torch.tensor(v))),
        _np(JT.rot_pc(jr, jnp.asarray(v))), atol=1e-5)
    np.testing.assert_allclose(
        _np(TT.transform_pc(torch.tensor(t), tr, torch.tensor(v))),
        _np(JT.transform_pc(jnp.asarray(t), jr, jnp.asarray(v))), atol=1e-5)
    # the raw tensor with its rot_type
    np.testing.assert_allclose(
        _np(TT.transform_pc(torch.tensor(t), torch.tensor(raw),
                            torch.tensor(v), rot_type=rot_type)),
        _np(JT.transform_pc(jnp.asarray(t), jnp.asarray(raw),
                            jnp.asarray(v), rot_type=rot_type)), atol=1e-5)


def test_rmat_rot_ignores_tf32(poses):
    """rmat_rot is a multiply and a sum, so TF32 matmuls cannot touch it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ours = TT.rmat_rot(torch.tensor(poses['r']), torch.tensor(poses['v']))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    ref = (poses['r'][:, :, None].astype(np.float64) *
           poses['v'][..., None, :]).sum(-1)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)


def test_numpy_helpers(poses):
    q, r, t, v = (poses[k][0, 0] for k in ('q', 'r', 't', 'v'))
    for name, args in (('qrot_np', (q, v)), ('qtransform_np', (t, q, v)),
                       ('rmat_rot_np', (r, v)),
                       ('rmat_transform_np', (t, r, v)),
                       ('quaternion_to_rmat', (q, )),
                       ('trans_rmat_to_pmat', (t, r)),
                       ('trans_quat_to_pmat', (t, q))):
        ours = getattr(TT, name)(*args)
        assert isinstance(ours, np.ndarray), name
        np.testing.assert_allclose(ours, getattr(JT, name)(*args),
                                   atol=1e-5, err_msg=name)


def test_random_rotation_matrixs_are_rotations():
    """Drawn from a torch.Generator (JAX draws from a key, so the values
    differ by design): orthonormal, determinant +1, reproducible."""
    g = torch.Generator().manual_seed(0)
    r = TT.random_rotation_matrixs((4, 5), generator=g)
    assert r.shape == (4, 5, 3, 3)
    eye = torch.eye(3).expand(4, 5, 3, 3)
    torch.testing.assert_close(r @ r.transpose(-1, -2), eye, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(torch.linalg.det(r), torch.ones(4, 5),
                               atol=1e-5, rtol=0)
    again = TT.random_rotation_matrixs((4, 5),
                                       torch.Generator().manual_seed(0))
    assert torch.equal(r, again)
