"""Pose and point-cloud transforms (w-first quaternions, rotation matrices).

Port of multi_part_assembly_tpu/utils/transforms.py.
"""

import numpy as np
import torch

from .rotation import (Rotation3D, matrix_to_quaternion, quaternion_apply,
                       quaternion_invert, quaternion_multiply,
                       quaternion_to_matrix)

__all__ = [
    'random_quaternions', 'qmul', 'qrot', 'qtransform', 'qtransform_invert',
    'qrmat', 'rmatq', 'rmat_rot', 'rmat_transform', 'random_rotation_matrixs',
    'rot_pc', 'transform_pc', 'quaternion_to_rmat', 'trans_rmat_to_pmat',
    'trans_quat_to_pmat', 'qrot_np', 'qtransform_np', 'rmat_rot_np',
    'rmat_transform_np',
]


def random_quaternions(shape, generator=None, device=None,
                       dtype=torch.float32):
    """Uniform random unit quaternions with a non-negative real part:
    normalised 4D Gaussians (JAX transforms.py:25-36, drawn from a
    torch.Generator instead of a JAX key)."""
    if isinstance(shape, int):
        shape = (shape, )
    q = torch.randn(tuple(shape) + (4, ), generator=generator, device=device,
                    dtype=dtype)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def random_rotation_matrixs(shape, generator=None, device=None,
                            dtype=torch.float32):
    """Random rotation matrices from random quaternions
    (JAX transforms.py:39-41)."""
    return quaternion_to_matrix(
        random_quaternions(shape, generator, device, dtype))


def qmul(q, r):
    """Hamilton product (JAX transforms.py:44-46)."""
    return quaternion_multiply(q, r)


def qrmat(q):
    assert q.shape[-1] == 4
    return quaternion_to_matrix(q)


def rmatq(r):
    assert r.shape[-1] == r.shape[-2] == 3
    return matrix_to_quaternion(r)


def qrot(q, v):
    """Rotate points v (..., 3) by quaternions q (JAX transforms.py:59-63)."""
    if q.dim() == v.dim() - 1:
        q = q[..., None, :]
    return quaternion_apply(q, v)


def qtransform(t, q, v):
    """qrot, then translate (JAX transforms.py:66-71)."""
    assert t.shape[-1] == 3
    if t.dim() == v.dim() - 1:
        t = t[..., None, :]
    return qrot(q, v) + t


def qtransform_invert(t, q, tqv):
    """Inverse of qtransform (JAX transforms.py:74-79)."""
    assert t.shape[-1] == 3
    if t.dim() == tqv.dim() - 1:
        t = t[..., None, :]
    return qrot(quaternion_invert(q), tqv - t)


def rmat_rot(r, v):
    """Rotate points v (..., 3) by matrices r (..., 3, 3) as a broadcast
    multiply and a sum (JAX transforms.py:82-94): a K=3 contraction gains
    nothing from a matmul, and this form is exact f32 whatever the TF32
    setting."""
    assert r.shape[-1] == r.shape[-2] == 3
    assert v.shape[-1] == 3
    if r.dim() == v.dim():
        r = r[..., None, :, :]
    return (r * v[..., None, :]).sum(-1)


def rmat_transform(t, r, v):
    """rmat_rot, then translate (JAX transforms.py:97-101)."""
    assert t.shape[-1] == 3
    if t.dim() == v.dim() - 1:
        t = t[..., None, :]
    return rmat_rot(r, v) + t


def _raw(rot, rot_type):
    if rot_type is None:
        assert isinstance(rot, Rotation3D)
        return rot.rot, rot.rot_type
    return rot, rot_type


def rot_pc(rot, pc, rot_type=None):
    """Rotate a point cloud by a Rotation3D, or by a raw tensor of
    `rot_type` (JAX transforms.py:104-115)."""
    r, rot_type = _raw(rot, rot_type)
    if rot_type == 'quat':
        return qrot(r, pc)
    if rot_type == 'rmat':
        return rmat_rot(r, pc)
    raise NotImplementedError(f'{rot_type} is not supported')


def transform_pc(trans, rot, pc, rot_type=None):
    """Rotate, then translate a point cloud (JAX transforms.py:118-129)."""
    r, rot_type = _raw(rot, rot_type)
    if rot_type == 'quat':
        return qtransform(trans, r, pc)
    if rot_type == 'rmat':
        return rmat_transform(trans, r, pc)
    raise NotImplementedError(f'{rot_type} is not supported')


# numpy conveniences for host-side plumbing (JAX transforms.py:135-168)


def _np(fn, *arrays):
    return fn(*(torch.tensor(np.asarray(a)) for a in arrays)).numpy()


def qrot_np(q, v):
    return _np(qrot, q, v)


def qtransform_np(t, q, v):
    return _np(qtransform, t, q, v)


def rmat_rot_np(r, v):
    return _np(rmat_rot, r, v)


def rmat_transform_np(t, r, v):
    return _np(rmat_transform, t, r, v)


def quaternion_to_rmat(quat):
    """One w-first quat [4] -> its 3x3 matrix, numpy."""
    return _np(quaternion_to_matrix, quat)


def trans_rmat_to_pmat(trans, rmat):
    """Translation and rotation matrix -> homogeneous 4x4."""
    pose_mat = np.eye(4)
    pose_mat[:3, :3] = np.asarray(rmat)
    pose_mat[:3, -1] = np.asarray(trans)
    return pose_mat


def trans_quat_to_pmat(trans, quat):
    """Translation and quaternion -> homogeneous 4x4."""
    return trans_rmat_to_pmat(trans, quaternion_to_rmat(quat))
