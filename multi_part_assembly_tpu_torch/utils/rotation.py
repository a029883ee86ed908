"""3D rotation representations and the `Rotation3D` wrapper.

Port of multi_part_assembly_tpu/utils/rotation.py.  Representations:
  - ``quat``: (..., 4) w-first unit quaternion;
  - ``rmat``: (..., 3, 3) rotation matrix; the constructor turns a 6D input
    (..., 6) or (..., 2, 3) into one by Gram-Schmidt;
  - ``axis``: (..., 3) axis-angle.
Euler angles are an output-only conversion (`to_euler`).
"""

import math

import torch

__all__ = [
    'Rotation3D', 'qeuler', 'quaternion_to_matrix', 'matrix_to_quaternion',
    'axis_angle_to_quaternion', 'quaternion_to_axis_angle',
    'axis_angle_to_matrix', 'matrix_to_axis_angle', 'rot6d_to_matrix',
    'standardize_quaternion', 'quaternion_multiply', 'quaternion_invert',
    'quaternion_apply',
]

EPS = 1e-6


def quaternion_to_matrix(quat):
    """(..., 4) w-first quaternions -> (..., 3, 3) (JAX rotation.py:40-62)."""
    w, x, y, z = quat.unbind(-1)
    two_s = 2.0 / torch.clamp((quat * quat).sum(-1), min=EPS)
    m = torch.stack([
        1 - two_s * (y * y + z * z),
        two_s * (x * y - z * w),
        two_s * (x * z + y * w),
        two_s * (x * y + z * w),
        1 - two_s * (x * x + z * z),
        two_s * (y * z - x * w),
        two_s * (x * z - y * w),
        two_s * (y * z + x * w),
        1 - two_s * (x * x + y * y),
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def _sqrt_positive_part(x):
    """sqrt(max(0, x)) (JAX rotation.py:65-67)."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def matrix_to_quaternion(matrix):
    """(..., 3, 3) rotation matrices -> (..., 4) w-first quaternions
    (JAX rotation.py:70-111): all four candidates, each divided by
    2 * max(|q_i|, 0.1), and the one of the largest |q_i| taken, the first
    on a tie (as jnp.argmax)."""
    batch_shape = matrix.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = \
        matrix.reshape(batch_shape + (9, )).unbind(-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))
    candidates = torch.stack([
        torch.stack([q_abs[..., 0]**2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1]**2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2]**2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3]**2], -1),
    ], dim=-2)  # (..., 4, 4)
    candidates = candidates / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = q_abs.argmax(-1)  # the first maximum on a tie, as jnp.argmax
    index = best[..., None, None].expand(batch_shape + (1, 4))
    return torch.gather(candidates, -2, index)[..., 0, :]


def standardize_quaternion(quat):
    """Flip the sign so that the real part is non-negative
    (JAX rotation.py:114-116)."""
    return torch.where(quat[..., :1] < 0, -quat, quat)


def quaternion_multiply(a, b):
    """Hamilton product, broadcasting over batch (JAX rotation.py:119-131)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quaternion_invert(quat):
    """Conjugate of a unit quaternion (JAX rotation.py:134-136)."""
    # (w, -x, -y, -z): the product with (1, -1, -1, -1), bit for bit, made
    # on the device (a host constant cannot enter a captured CUDA graph)
    return torch.cat([quat[..., :1], -quat[..., 1:]], dim=-1)


def quaternion_apply(quat, point):
    """Rotate (..., 3) points by (..., 4) quaternions:
    p + 2 w (v x p) + 2 v x (v x p) (JAX rotation.py:139-150)."""
    w = quat[..., :1]
    v = quat[..., 1:]
    v, point = torch.broadcast_tensors(v, point)
    cross1 = torch.linalg.cross(v, point, dim=-1)
    cross2 = torch.linalg.cross(v, cross1, dim=-1)
    return point + 2.0 * (w * cross1 + cross2)


def _sin_half_over_angle(angle, half):
    """sin(angle / 2) / angle, by its Taylor series below 1e-6."""
    return torch.where(angle < 1e-6, 0.5 - (angle * angle) / 48.0,
                       torch.sin(half) / torch.clamp(angle, min=1e-12))


def axis_angle_to_quaternion(axis_angle):
    """(..., 3) axis-angle -> w-first quaternion (JAX rotation.py:153-165)."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angle * 0.5
    return torch.cat([torch.cos(half),
                      axis_angle * _sin_half_over_angle(angle, half)], -1)


def quaternion_to_axis_angle(quat):
    """w-first quaternion -> (..., 3) axis-angle, angle = 2 atan2(|v|, w)
    (JAX rotation.py:168-183)."""
    norm = torch.linalg.norm(quat[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norm, quat[..., :1])
    return quat[..., 1:] / _sin_half_over_angle(2.0 * half, half)


def axis_angle_to_matrix(axis_angle):
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix):
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rot6d_to_matrix(d6):
    """(..., 6) two 3D rows -> (..., 3, 3) with rows (b1, b2, b1 x b2) by
    Gram-Schmidt, norms floored at EPS (JAX rotation.py:194-207)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True),
                          min=EPS)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.norm(a2p, dim=-1, keepdim=True),
                           min=EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def qeuler(q, order='zyx', epsilon=0.0, to_degree=False):
    """(..., 4) w-first quaternions -> (..., 3) Euler angles (x, y, z) in
    the given axis order (JAX rotation.py:212-250); `epsilon` clamps the
    arcsin input."""
    assert q.shape[-1] == 4
    q0, q1, q2, q3 = q.unbind(-1)

    def asin(x):
        return torch.asin(torch.clamp(x, -1 + epsilon, 1 - epsilon))

    atan2 = torch.atan2
    if order == 'xyz':
        x = atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = asin(2 * (q1 * q3 + q0 * q2))
        z = atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    elif order == 'yzx':
        x = atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = asin(2 * (q1 * q2 + q0 * q3))
    elif order == 'zxy':
        x = asin(2 * (q0 * q1 + q2 * q3))
        y = atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        z = atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == 'xzy':
        x = atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = atan2(2 * (q0 * q2 + q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = asin(2 * (q0 * q3 - q1 * q2))
    elif order == 'yxz':
        x = asin(2 * (q0 * q1 - q2 * q3))
        y = atan2(2 * (q1 * q3 + q0 * q2), 1 - 2 * (q1 * q1 + q2 * q2))
        z = atan2(2 * (q1 * q2 + q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == 'zyx':
        x = atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = asin(2 * (q0 * q2 - q1 * q3))
        z = atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    else:
        raise ValueError(f'unknown euler order {order}')
    euler = torch.stack([x, y, z], dim=-1)
    if to_degree:
        euler = euler * (180.0 / math.pi)
    return euler


_CONVERT = {
    ('quat', 'rmat'): quaternion_to_matrix,
    ('quat', 'axis'): quaternion_to_axis_angle,
    ('rmat', 'quat'): matrix_to_quaternion,
    ('rmat', 'axis'): matrix_to_axis_angle,
    ('axis', 'quat'): axis_angle_to_quaternion,
    ('axis', 'rmat'): axis_angle_to_matrix,
}


class Rotation3D:
    """A rotation tensor tagged with its representation
    (JAX rotation.py:268-410): `convert`, `to_quat/to_rmat/to_axis_angle`,
    `to_euler`, `apply_rotation`, shape ops, indexing, `cat`/`stack`."""

    ROT_TYPE = ('quat', 'rmat', 'axis')

    def __init__(self, rot, rot_type='quat'):
        if rot_type not in self.ROT_TYPE:
            raise ValueError(f'unsupported rot_type {rot_type!r}')
        if rot.dtype not in (torch.float32, torch.float64, torch.bfloat16):
            rot = rot.float()
        if rot_type == 'quat':
            if rot.shape[-1] != 4:
                raise ValueError(f'wrong quaternion shape {tuple(rot.shape)}')
            # zero-norm (padded) quats -> identity (JAX rotation.py:283-289)
            sq_norm = (rot * rot).sum(-1, keepdim=True)
            iden = torch.zeros_like(rot)
            iden[..., 0] = 1.0
            rot = torch.where(sq_norm > 0.25, rot, iden)
        elif rot_type == 'rmat':
            if rot.shape[-2:] == (3, 3):
                pass
            elif rot.shape[-2:] == (2, 3):
                rot = rot6d_to_matrix(rot.reshape(rot.shape[:-2] + (6, )))
            elif rot.shape[-1] == 6:
                rot = rot6d_to_matrix(rot)
            else:
                raise ValueError('wrong rotation matrix shape '
                                 f'{tuple(rot.shape)}')
        elif rot.shape[-1] != 3:
            raise ValueError(f'wrong axis-angle shape {tuple(rot.shape)}')
        self._rot = rot
        self._rot_type = rot_type

    @classmethod
    def _wrap(cls, rot, rot_type):
        """Build without the constructor's normalisation."""
        obj = object.__new__(cls)
        obj._rot = rot
        obj._rot_type = rot_type
        return obj

    @property
    def rot(self):
        return self._rot

    @property
    def rot_type(self):
        return self._rot_type

    def convert(self, rot_type):
        if rot_type not in self.ROT_TYPE:
            raise ValueError(f'unknown target {rot_type!r}')
        if rot_type == self._rot_type:
            return self
        fn = _CONVERT[(self._rot_type, rot_type)]
        return self._wrap(fn(self._rot), rot_type)

    def to_quat(self):
        return self.convert('quat').rot

    def to_rmat(self):
        return self.convert('rmat').rot

    def to_axis_angle(self):
        return self.convert('axis').rot

    def to_euler(self, order='zyx', to_degree=True):
        return qeuler(self.to_quat(), order=order, to_degree=to_degree)

    def apply_rotation(self, rot):
        """Left-multiply by another Rotation3D (JAX rotation.py:351-361)."""
        assert rot.rot_type in ('quat', 'rmat')
        rot = rot.convert(self._rot_type)
        if self._rot_type == 'quat':
            new_rot = quaternion_multiply(rot.rot, self._rot)
        elif self._rot_type == 'rmat':
            new_rot = rot.rot @ self._rot
        else:
            raise NotImplementedError('apply_rotation on axis-angle')
        return self._wrap(new_rot, self._rot_type)

    @property
    def shape(self):
        return self._rot.shape

    @property
    def dtype(self):
        return self._rot.dtype

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._wrap(self._rot.reshape(shape), self._rot_type)

    def squeeze(self, dim=None):
        rot = self._rot.squeeze() if dim is None else self._rot.squeeze(dim)
        return self._wrap(rot, self._rot_type)

    def unsqueeze(self, dim):
        return self._wrap(self._rot.unsqueeze(dim), self._rot_type)

    def __getitem__(self, key):
        return self._wrap(self._rot[key], self._rot_type)

    def __len__(self):
        return self._rot.shape[0]

    def detach(self):
        return self._wrap(self._rot.detach(), self._rot_type)

    def clone(self):
        return self._wrap(self._rot.clone(), self._rot_type)

    @staticmethod
    def cat(rot_lst, dim=0):
        rot_type = rot_lst[0].rot_type
        assert all(r.rot_type == rot_type for r in rot_lst)
        return Rotation3D._wrap(torch.cat([r.rot for r in rot_lst], dim),
                                rot_type)

    @staticmethod
    def stack(rot_lst, dim=0):
        rot_type = rot_lst[0].rot_type
        assert all(r.rot_type == rot_type for r in rot_lst)
        return Rotation3D._wrap(torch.stack([r.rot for r in rot_lst], dim),
                                rot_type)

    def __repr__(self):
        return (f'Rotation3D(rot_type={self._rot_type}, '
                f'shape={tuple(self._rot.shape)})')
