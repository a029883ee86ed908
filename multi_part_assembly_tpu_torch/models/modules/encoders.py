"""Point-cloud encoders: PointNet, DGCNN, PointNet++ (SSG, MSG).

Port of multi_part_assembly_tpu/models/modules/encoders.py.  Channels-last
throughout: a Conv(k=1) over [B, C, N] is a matmul over [B, N, C].  Batch
norms are `MaskedBatchNorm`, so padded parts never enter the statistics.
The layers keep the torch reference's modules and names (Conv1d / Conv2d
weights, `Sequential` indices), so its weights load by name.
"""

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.knn import get_graph_feature, knn, neighborhood_reduce
from ...ops.max_pool import max_pool
from ...ops.sampling import (ball_query, furthest_point_sample, gather_points,
                             group_points, three_interpolate, three_nn)
from ...parallel.dist import all_reduce_sum, world
from ...utils import tracing
from .norm import MaskedBatchNorm, frozen_stats

__all__ = ['PointNet', 'DGCNN', 'PointNet2SSG', 'PointNet2MSG',
           'FeaturePropagation', 'build_encoder']


class PointNet(nn.Module):
    """5 x (pointwise linear + masked BN + ReLU), no ReLU after the last BN,
    then a global max-pool over the points: 3-64-64-64-128-feat (JAX
    encoders.py:27-55).

    The layers are Conv1d(k=1) modules, as in the torch reference, so its
    weights load by name; they run channels-last as one matmul over
    [..., N, C].  The matmuls run in `compute_dtype`; BN statistics and the
    pooled output are f32.  Each ReLU runs inside its batch norm's call
    (`relu=True`), on the card in the same kernel.  The pool is the device
    region `max_pool` (`ops/max_pool.py`: the kernels on the card, each
    launch counted as `launch.pool_fwd` or `launch.pool_bwd`).
    """

    def __init__(self, feat_dim, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        dims = (3, 64, 64, 64, 128, feat_dim)
        for i in range(1, 6):
            setattr(self, f'conv{i}',
                    nn.Conv1d(dims[i - 1], dims[i], 1, bias=False))
            setattr(self, f'bn{i}', MaskedBatchNorm(dims[i]))

    def forward(self, x, mask=None):
        """x: [..., N, 3]; mask: [...] per-cloud validity for BN stats.
        Returns [..., feat_dim]."""
        point_mask = None if mask is None else mask[..., None]
        cdt = self.compute_dtype
        x = x.to(cdt)
        for i in range(1, 6):
            w = getattr(self, f'conv{i}').weight[:, :, 0]
            x = F.linear(x, w.to(cdt))
            x = getattr(self, f'bn{i}')(x, point_mask, relu=i < 5)
        x, = tracing.region_begin('max_pool', x)
        out, = tracing.region_end('max_pool', max_pool(x))
        return out


def _knn_rows(B, N, budget=512 * 1024 * 1024):
    """Largest divisor of N whose [B, rows, N] f32 Gram block fits `budget`
    bytes; None when the whole [B, N, N] Gram fits (JAX :58-67)."""
    target = budget // max(1, B * N * 4)
    if target >= N:
        return None
    for rows in range(max(1, int(target)), 0, -1):
        if N % rows == 0:
            return rows
    return 1


class DGCNN(nn.Module):
    """4 EdgeConv stages (k = 20) + a fusing conv, max||mean pool + out_fc
    (JAX encoders.py:70-192; reference encoder/dgcnn.py:41-109).

    The kNN graph is built in f32; the stages run in `compute_dtype` with
    f32 batch-norm statistics.  Each EdgeConv stage is collapsed, as in the
    JAX package: the conv of [x_j - x_i, x_i] is u_j + w_i with
    u = x W_top and w = x (W_bot - W_top), and since the batch norm is a
    per-channel affine f z + o and LeakyReLU is monotone, the max over the
    k neighbours is leaky(f (w_i + max_j u_j) + o) where f >= 0 and the
    same with min_j u_j where f < 0.  So the stage needs only the
    neighbourhood max, min, sum and sum of squares of u
    (`ops.knn.neighborhood_reduce`); the train-mode moments over the edges
    come from the sums, in one pass, the variance E[z^2] - mean^2 clamped
    at 0 as JAX computes it (:170-184), and enter the batch norm as
    injected statistics, summed over the ranks under data parallelism in
    both BN modes.  The [B, N, k, 2C] edge tensor never exists.

    `naive=True` runs the reference-shaped edge tensor (small inputs; the
    equality test holds the two against each other).

    Parameters as in the reference: `conv{1-4}` are Sequential(Conv2d
    [d, 2C, 1, 1], bn{i}, LeakyReLU) and `conv5` Sequential(Conv1d
    [feat, 512, 1], bn5, LeakyReLU); each `bn{i}` is also registered as
    `conv{i}.1`, so the state_dict holds it under both names, as the
    reference's does."""

    def __init__(self, feat_dim, k=20, naive=False,
                 compute_dtype=torch.float32):
        super().__init__()
        self.k = k
        self.naive = naive
        self.compute_dtype = compute_dtype
        dims = (3, 64, 64, 128, 256)
        for i in range(1, 5):
            bn = MaskedBatchNorm(dims[i])
            setattr(self, f'bn{i}', bn)
            setattr(self, f'conv{i}', nn.Sequential(
                nn.Conv2d(2 * dims[i - 1], dims[i], 1, bias=False), bn,
                nn.LeakyReLU(0.2)))
        self.bn5 = MaskedBatchNorm(feat_dim)
        self.conv5 = nn.Sequential(
            nn.Conv1d(sum(dims[1:]), feat_dim, 1, bias=False), self.bn5,
            nn.LeakyReLU(0.2))
        self.out_fc = nn.Linear(2 * feat_dim, feat_dim)

    def forward(self, x, mask=None):
        """x: [B, N, 3]; mask: [B] validity.  Returns [B, feat_dim]."""
        cdt = self.compute_dtype
        edge_mask = None if mask is None else mask[:, None, None]
        feats = []
        h = x
        for i in range(1, 5):
            conv = getattr(self, f'conv{i}')[0]
            bn = getattr(self, f'bn{i}')
            W = conv.weight[:, :, 0, 0]  # [d, 2C]
            if self.naive:
                e = get_graph_feature(h.float(), k=self.k).to(cdt)
                e = bn(F.linear(e, W.to(cdt)), edge_mask)
                h = F.leaky_relu(e, 0.2).amax(dim=2)  # [B, N, d]
            else:
                h = self._edge_stage(h, W, bn, edge_mask)
            feats.append(h)
        h = torch.cat(feats, dim=-1)  # [B, N, 512]
        h = F.linear(h, self.conv5[0].weight[:, :, 0].to(cdt))
        h = self.bn5(h, None if mask is None else mask[:, None])
        h = F.leaky_relu(h, 0.2).float()
        g = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
        return self.out_fc(g)

    def _edge_stage(self, h, W, bn, edge_mask):
        """One EdgeConv stage in the collapsed form (class docstring)."""
        cdt = self.compute_dtype
        B, N, C = h.shape
        idx = knn(h.float(), self.k, rows_per_block=_knn_rows(B, N))
        hc = h.to(cdt)
        W_top, W_bot = W[:, :C], W[:, C:]
        u = F.linear(hc, W_top.to(cdt))  # x W_top
        w = F.linear(hc, (W_bot - W_top).to(cdt))  # x (W_bot - W_top)
        train = self.training
        with torch.profiler.record_function('neighborhood_reduce'):
            mx, mn, s, q = neighborhood_reduce(u, idx, train)
        wf = w.float()
        stats = None
        if train:
            k = float(self.k)
            per_i = s + k * wf  # sum_j z_ij of row i
            per_i2 = q + 2.0 * wf * s + k * wf * wf  # sum_j z_ij^2
            if edge_mask is None:
                count = torch.full((), float(B * N) * k, dtype=wf.dtype,
                                   device=wf.device)
                tot, tot2 = per_i.sum((0, 1)), per_i2.sum((0, 1))
            else:
                mw = edge_mask.float()  # [B, 1, 1]
                count = mw.sum() * N * k
                tot = (per_i * mw).sum((0, 1))
                tot2 = (per_i2 * mw).sum((0, 1))
            if world() > 1:
                # global sums under either BN mode: injected statistics
                # stay sync, as JAX's override the per-replica groups
                # (norm.py:79-86)
                sums = all_reduce_sum(torch.cat([tot, tot2,
                                                 count.reshape(1)]))
                tot, tot2, count = sums[:-1].chunk(2) + (sums[-1], )
            denom = torch.clamp(count, min=1.0)
            mean = tot / denom
            var = torch.clamp(tot2 / denom - mean * mean, min=0.0)
            stats = (mean, var, denom)
        factor, offset = bn(wf, stats=stats, affine_only=True)
        sel = torch.where(factor >= 0, mx, mn)  # per-channel max/min pick
        out = F.leaky_relu(factor * (wf + sel) + offset, 0.2)
        return out.to(cdt)


class _SharedMLP(nn.Sequential):
    """(Conv2d(k=1) + BN + ReLU) x len(dims) over grouped features, as the
    reference's `build_shared_mlp` (pointnet2_modules.py:9-19): Sequential
    indices 3i (conv [d, in, 1, 1]), 3i + 1 (BN), 3i + 2 (ReLU).  Runs
    channels-last in `compute_dtype`, f32 statistics (lean: norm.py) and
    output (JAX encoders.py:195-211)."""

    def __init__(self, in_dim, dims, compute_dtype=torch.float32):
        layers = []
        for d in dims:
            layers += [nn.Conv2d(in_dim, d, 1, bias=False),
                       MaskedBatchNorm(d, lean=True), nn.ReLU()]
            in_dim = d
        super().__init__(*layers)
        self.compute_dtype = compute_dtype

    def forward(self, x, mask=None, pool=False):
        """x: [..., C_in] -> [..., C] f32; `pool`: the max over axis 2 first
        (exact in `compute_dtype`, and the f32 copy is nsample times
        smaller)."""
        cdt = self.compute_dtype
        x = x.to(cdt)
        for i in range(0, len(self), 3):
            w = self[i].weight.reshape(self[i].weight.shape[:2])
            x = F.relu(self[i + 1](F.linear(x, w.to(cdt)), mask))
        return (x.amax(dim=2) if pool else x).float()


def _recomputed(fn, *args):
    """fn(*args), its activations recomputed in the backward pass instead of
    kept (JAX's `nn.remat`); the recompute leaves the running statistics
    alone, so a step updates them once."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          frozen_stats()))


class _SetAbstraction(nn.Module):
    """FPS -> ball query -> shared MLP -> max-pool per scale, the scales
    concatenated; `group_all` (npoint = 0) groups the whole cloud in one
    (JAX encoders.py:214-264; reference pointnet2_modules.py:22-74).

    Each scale's group -> MLP -> pool runs under `_recomputed`: the grouped
    activations, [B, npoint, nsample, C], are recomputed in the backward
    pass and never kept.  FPS and the ball query (integer indices) stay
    outside: they run once a step, and the backward keeps only their
    indices."""

    def __init__(self, in_dim, npoint, radii, nsamples, mlps,
                 compute_dtype=torch.float32):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.mlps = nn.ModuleList([
            _SharedMLP(in_dim + 3, dims, compute_dtype) for dims in mlps])

    def forward(self, xyz, features, mask=None):
        """xyz: [B, N, 3]; features: [B, N, C] or None.  Returns
        (new_xyz [B, npoint, 3] or None, [B, npoint or 1, C'])."""
        m = None if mask is None else mask[:, None, None]
        if not self.npoint:  # group_all
            def stage_all(xyz_a, feats_a):
                grouped = xyz_a[:, None]  # [B, 1, N, 3]
                if feats_a is not None:
                    grouped = torch.cat([grouped, feats_a[:, None]], -1)
                return self.mlps[0](grouped, m, pool=True)  # [B, 1, C']
            return None, _recomputed(stage_all, xyz, features)

        fps_idx = furthest_point_sample(xyz, self.npoint)
        new_xyz = gather_points(xyz, fps_idx)  # [B, npoint, 3]
        outs = []
        for mlp, r, s in zip(self.mlps, self.radii, self.nsamples):
            idx = ball_query(r, s, xyz, new_xyz)  # [B, npoint, s]

            def stage(xyz_a, new_xyz_a, feats_a, idx=idx, mlp=mlp):
                grouped = group_points(xyz_a, idx) - new_xyz_a[:, :, None]
                if feats_a is not None:
                    grouped = torch.cat(
                        [grouped, group_points(feats_a, idx)], dim=-1)
                return mlp(grouped, m, pool=True)  # [B, npoint, C']
            outs.append(_recomputed(stage, xyz, new_xyz, features))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance feature upsampling + shared MLP (JAX
    encoders.py:267-291; reference pointnet2_modules.py:149-209).  No
    shipped encoder uses it."""

    def __init__(self, in_dim, mlp, compute_dtype=torch.float32):
        super().__init__()
        self.mlp = _SharedMLP(in_dim, mlp, compute_dtype)

    def forward(self, unknown, known, unknown_feats, known_feats, mask=None):
        """unknown: [B, n, 3]; known: [B, m, 3] or None (one global
        feature); unknown_feats: [B, n, C1] or None; known_feats:
        [B, m, C2]."""
        if known is not None:
            dist, idx = three_nn(unknown, known)
            recip = 1.0 / torch.clamp(dist, min=1e-8)
            weight = recip / recip.sum(2, keepdim=True)
            interp = three_interpolate(known_feats, idx, weight)
        else:
            interp = known_feats.expand(*unknown.shape[:2],
                                        known_feats.shape[-1])
        feats = interp if unknown_feats is None else \
            torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(feats, None if mask is None else mask[:, None])


# (npoint, radii, nsamples, mlps) of the SA stages before the group_all one
_SSG = ((512, (0.2, ), (64, ), ((64, 64, 128), )),
        (128, (0.4, ), (64, ), ((128, 128, 256), )))
_MSG = ((512, (0.1, 0.2, 0.4), (16, 32, 128),
         ((32, 32, 64), (64, 64, 128), (64, 96, 128))),
        (128, (0.2, 0.4, 0.8), (32, 64, 128),
         ((64, 64, 128), (128, 128, 256), (128, 128, 256))))


class _PointNet2(nn.Module):
    """Two set abstractions and a group_all one (256-512-feat), the modules
    named as the reference's `SA_modules`."""

    stages = ()

    def __init__(self, feat_dim, compute_dtype=torch.float32):
        super().__init__()
        sa, in_dim = [], 0
        for npoint, radii, nsamples, mlps in self.stages:
            sa.append(_SetAbstraction(in_dim, npoint, radii, nsamples, mlps,
                                      compute_dtype))
            in_dim = sum(dims[-1] for dims in mlps)
        sa.append(_SetAbstraction(in_dim, 0, (), (), ((256, 512, feat_dim), ),
                                  compute_dtype))
        self.SA_modules = nn.ModuleList(sa)

    def forward(self, x, mask=None):
        """x: [B, N, 3]; mask: [B] validity.  Returns [B, feat_dim]."""
        xyz, feats = x.float(), None
        for sa in self.SA_modules:
            xyz, feats = sa(xyz, feats, mask)
        return feats[:, 0]


class PointNet2SSG(_PointNet2):
    """PointNet++ single-scale grouping (JAX encoders.py:294-312;
    reference pointnet2_ssg.py:19-66)."""

    stages = _SSG


class PointNet2MSG(_PointNet2):
    """PointNet++ multi-scale grouping (JAX encoders.py:315-335; reference
    pointnet2_msg.py:15-43)."""

    stages = _MSG


def build_encoder(arch, feat_dim, compute_dtype=torch.float32):
    """Encoder factory (JAX encoders.py:338-348)."""
    cls = {'pointnet': PointNet, 'dgcnn': DGCNN,
           'pointnet2_ssg': PointNet2SSG,
           'pointnet2_msg': PointNet2MSG}.get(arch)
    if cls is None:
        raise NotImplementedError(f'unknown encoder {arch}')
    return cls(feat_dim, compute_dtype=compute_dtype)
