"""Pose regression heads (port of multi_part_assembly_tpu/models/modules/
regressor.py): a unit quaternion, or a 6D rotation (`rot_type='rmat'`)."""

import torch
import torch.nn.functional as F
from torch import nn

from ...utils import tracing

__all__ = ['PoseRegressor', 'StochasticPoseRegressor', 'normalize_rot6d']


def normalize_rot6d(rot):
    """Gram-Schmidt the two 3-vectors of a 6D rotation, norms floored at
    1e-12 (JAX regressor.py:12-19)."""
    a1, a2 = rot[..., :3], rot[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True),
                          min=1e-12)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.clamp(torch.linalg.norm(b2, dim=-1, keepdim=True),
                          min=1e-12)
    return torch.cat([b1, b2], dim=-1)


class PoseRegressor(nn.Module):
    """MLP head: feat -> 256 -> 128 -> (rot, trans), rot a unit quaternion
    or a Gram-Schmidt 6D rotation (JAX regressor.py:22-48).  The hidden
    matmuls run in `compute_dtype`; the heads and the rotation
    normalisation stay f32.  Each call is the device region `pose_head`
    (utils/tracing.py)."""

    def __init__(self, in_dim, rot_type='quat', norm_rot=True,
                 compute_dtype=torch.float32):
        super().__init__()
        self.rot_type = rot_type
        self.norm_rot = norm_rot
        self.compute_dtype = compute_dtype
        self.fc_layers = nn.Sequential(
            nn.Linear(in_dim, 256), nn.LeakyReLU(0.2),
            nn.Linear(256, 128), nn.LeakyReLU(0.2))
        self.rot_head = nn.Linear(128, 4 if rot_type == 'quat' else 6)
        self.trans_head = nn.Linear(128, 3)

    def forward(self, x):
        x, = tracing.region_begin('pose_head', x)
        return tracing.region_end('pose_head', *self._regress(x))

    def _regress(self, x):
        cdt = self.compute_dtype
        f = x.to(cdt)
        for layer in self.fc_layers:
            if isinstance(layer, nn.Linear):
                f = F.linear(f, layer.weight.to(cdt), layer.bias.to(cdt))
            else:
                f = layer(f)
        f = f.float()
        rot = self.rot_head(f)
        if self.norm_rot and self.rot_type == 'quat':
            rot = rot / torch.clamp(
                torch.linalg.norm(rot, dim=-1, keepdim=True), min=1e-12)
        elif self.norm_rot:
            rot = normalize_rot6d(rot)
        return rot, self.trans_head(f)


class StochasticPoseRegressor(PoseRegressor):
    """PoseRegressor with `noise_dim` Gaussian features appended to its
    input, drawn from `generator` (JAX regressor.py:51-68).

    `noise_override`, a list of `[..., noise_dim]` tensors, replaces the
    draws: each call takes the next one off the front (tests, and the
    card-against-CPU checks of chip_smoke.py, give both sides the same
    noise); None draws."""

    def __init__(self, feat_dim, noise_dim, rot_type='quat', norm_rot=True,
                 compute_dtype=torch.float32):
        super().__init__(feat_dim + noise_dim, rot_type, norm_rot,
                         compute_dtype)
        self.noise_dim = noise_dim
        self.noise_override = None

    def forward(self, x, generator=None):
        x, = tracing.region_begin('pose_head', x)
        if self.noise_dim > 0:
            if self.noise_override is not None:  # empty: IndexError
                noise = self.noise_override.pop(0).to(x)
            else:
                noise = torch.randn(x.shape[:-1] + (self.noise_dim, ),
                                    generator=generator, device=x.device,
                                    dtype=x.dtype)
            x = torch.cat([x, noise], dim=-1)
        return tracing.region_end('pose_head', *self._regress(x))
