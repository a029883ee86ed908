"""MaskedBatchNorm's routes (models/modules/norm.py, ops/masked_bn.py) on
the CPU: which calls the kernels would take, the rows and weights they
would be given, and the plain route's ReLU.

The kernels themselves run only on a card (tests/test_torch_cuda.py,
`-k masked_bn`).  Here the route is read with the device condition held
true by a stand-in that reports `is_cuda` and forwards everything else to
a CPU tensor.
"""

import os
import sys

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from multi_part_assembly_tpu_torch.models.modules import norm  # noqa: E402
from multi_part_assembly_tpu_torch.models.modules.encoders import \
    PointNet  # noqa: E402
from multi_part_assembly_tpu_torch.ops import masked_bn as MB  # noqa: E402
from multi_part_assembly_tpu_torch.utils import tracing  # noqa: E402


class _OnCard:
    """A CPU tensor that says it is on the card."""

    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _x(shape=(2, 5, 16, 64), dtype=torch.bfloat16):
    return torch.randn(shape).to(dtype)


_MASK = torch.tensor([[1., 1., 0., 0., 0.], [1., 0., 0., 0., 0.]])[..., None]

# name -> (layer keywords, x, mask, call keywords, ranks, eval, route).
# The route follows the function asked for alone: x's type, channel count
# and layout and the mask's shape do not change it (the kernels take the
# layout, `test_kernels_take_any_layout_of_their_rows`, or raise).
ROUTES = {
    'train': ({}, _x(), _MASK, {}, 1, False, 'fused'),
    'train_no_mask': ({}, _x(), None, {}, 1, False, 'fused'),
    'train_f32': ({}, _x(dtype=torch.float32), _MASK, {}, 1, False,
                  'fused'),
    'point_mask': ({}, _x(), torch.ones(2, 5, 16), {}, 1, False, 'fused'),
    'dgcnn_bn5': ({}, _x((2, 16, 64)), torch.ones(2, 1), {}, 1, False,
                  'fused'),
    'eval': ({}, _x(), _MASK, {}, 1, True, 'plain'),
    'eval_sync_ranks': ({}, _x(), _MASK, {}, 2, True, 'plain'),
    'lean': ({'lean': True}, _x(), _MASK, {}, 1, False, 'plain'),
    'stats': ({}, _x(), None, {'stats': (torch.zeros(64), torch.ones(64),
                                         torch.ones(()))}, 1, False,
              'plain'),
    'affine_only': ({}, _x(), None, {'affine_only': True}, 1, False,
                    'plain'),
    'sync_ranks': ({}, _x(), _MASK, {}, 2, False, 'plain'),
    'replica_ranks': ({'sync': False}, _x(), _MASK, {}, 2, False, 'fused'),
    'channels_not_8': ({}, _x((2, 5, 16, 12)), _MASK, {}, 1, False,
                       'fused'),
    'mask_not_grouped': ({}, _x(), torch.ones(2, 1, 16), {}, 1, False,
                         'fused'),
    'mask_broadcast_lead': ({}, _x(), torch.ones(1, 5, 1), {}, 1, False,
                            'fused'),
    'f16': ({}, _x(dtype=torch.float16), _MASK, {}, 1, False, 'fused'),
    'not_contiguous': ({}, _x((2, 5, 64, 16)).transpose(-1, -2), _MASK, {},
                       1, False, 'fused'),
}


@pytest.mark.parametrize('name', sorted(ROUTES))
def test_route_follows_what_the_call_shows(name, monkeypatch):
    """Train mode on one rank or per replica takes the kernels ('fused');
    eval mode, the lean layers, injected statistics, the affine alone and
    sync BN over several ranks stay plain, whatever x's type, width and
    layout and the mask's shape."""
    layer_kw, x, mask, call_kw, ranks, evaluate, want = ROUTES[name]
    monkeypatch.setattr(norm, 'world', lambda: ranks)
    bn = norm.MaskedBatchNorm(x.shape[-1], **layer_kw)
    bn.train(not evaluate)
    assert bn.route(_OnCard(x), **call_kw) == want
    assert bn.route(x, **call_kw) == 'plain'  # a CPU tensor


@pytest.mark.parametrize('shape,mask_shape,want', [
    ((2, 5, 16, 64), (2, 5, 1), (10, 16)),
    ((2, 5, 16, 64), (5, 1), (10, 16)),
    ((2, 5, 16, 64), (2, 5, 16), (160, 1)),
    ((2, 5, 16, 64), (2, 1, 16), (160, 1)),
    ((2, 5, 16, 64), (1, 5, 1), (10, 16)),
    ((2, 5, 16, 64), (2, 1, 1), (2, 80)),
    ((2, 5, 16, 64), (1, 1, 1), (1, 160)),
    ((2, 5, 16, 64), None, (1, 160)),
    ((2, 16, 64), (2, 1), (2, 16)),
    ((2, 16, 64), (), (1, 32)),
    ((2, 16, 64), (1, 2, 1), None),
    ((2, 5, 16, 64), (3, 5, 1), None),
])
def test_row_weights(shape, mask_shape, want):
    """The kernels' weights, (groups, fan): one a run of `fan` consecutive
    rows, repeating to the mask broadcast over every row, for any mask
    that broadcasts; a mask that does not raises."""
    if want is None:
        with pytest.raises(ValueError, match='broadcast'):
            MB.row_weights(torch.ones(mask_shape), shape)
        return
    mask = None if mask_shape is None else \
        (torch.rand(mask_shape) > 0.4).float()
    w, fan = MB.row_weights(mask, shape)
    assert (1 if w is None else w.numel(), fan) == want
    if mask is not None:
        assert w.dtype == torch.float32 and w.is_contiguous()
        assert torch.equal(w.repeat_interleave(fan),
                           mask.expand(shape[:-1]).reshape(-1))


def test_kernels_take_any_layout_of_their_rows():
    """`kernel_rows` gives the kernels contiguous, 16-byte aligned rows of
    the same values: a strided view and a misaligned one are copied, an
    aligned contiguous x is passed as it is."""
    x = _x((2, 5, 16, 64))
    assert MB.kernel_rows(x) is x
    strided = x.transpose(0, 1)
    flat = torch.arange(8 * 17, dtype=torch.float32).to(torch.bfloat16)
    misaligned = flat[1:1 + 8 * 16].view(16, 8)
    assert misaligned.data_ptr() % 16
    for t in (strided, misaligned):
        got = MB.kernel_rows(t)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, t)
        assert MB._rows(got)[:2] == (t.numel() // t.shape[-1], t.shape[-1])


@pytest.mark.parametrize('name,x', [
    ('f16', _x(dtype=torch.float16)),
    ('channels_not_8', _x((2, 5, 16, 12))),
    ('not_contiguous', _x((2, 5, 64, 16)).transpose(-1, -2)),
    ('misaligned', torch.zeros(8 * 17, dtype=torch.bfloat16)[1:1 + 8 * 16]
     .view(16, 8)),
    ('no_rows', _x((0, 64))),
])
def test_kernels_refuse_what_they_cannot_take(name, x):
    """A type, a channel count or a layout the kernels do not take raises
    before any launch: nothing falls back to the plain version."""
    with pytest.raises(ValueError, match='expected contiguous'):
        MB._rows(x)


def test_cpu_takes_the_plain_route_and_counts_nothing():
    """The PointNet on the CPU: every batch norm plain, no kernel
    launched (no `launch.bn_*` counted)."""
    net = PointNet(16, compute_dtype=torch.bfloat16).train()
    x = torch.randn(2, 4, 10, 3)
    assert net.bn1.route(x) == 'plain'
    tracing.reset()
    net(x, _MASK[:, :4, 0]).sum().backward()
    assert not any(k.startswith('launch.bn_') for k in tracing.counters())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('training', [True, False])
@pytest.mark.parametrize('masked', [True, False])
def test_relu_inside_is_bn_then_relu(dtype, training, masked):
    """`relu=True` on the plain route is bitwise the batch norm and then
    F.relu: output, input gradient, weight and bias gradients and the
    running statistics."""
    x = _x(dtype=dtype)
    mask = _MASK if masked else None
    cot = torch.randn(x.shape).to(dtype)
    got = []
    for inside in (True, False):
        torch.manual_seed(0)
        bn = norm.MaskedBatchNorm(64).train(training)
        bn.weight.data.uniform_(0.5, 1.5)
        bn.bias.data.normal_()
        xg = x.clone().requires_grad_(True)
        y = bn(xg, mask, relu=True) if inside else F.relu(bn(xg, mask))
        (y * cot).sum().backward()
        got.append((y, xg.grad, bn.weight.grad, bn.bias.grad,
                    bn.running_mean, bn.running_var))
    for a, b in zip(*got):
        assert torch.equal(a, b)


def test_plain_route_is_the_affine_of_the_moments():
    """The plain route's pieces: the layer's output is
    normalize_plain(x, *affine(weight, bias, *moments_plain(x, mask)))."""
    x = _x()
    bn = norm.MaskedBatchNorm(64).train()
    bn.weight.data.uniform_(0.5, 1.5)
    mean, var, _ = MB.moments_plain(x, _MASK)
    _, factor, offset = MB.affine(bn.weight, bn.bias, mean, var, bn.eps)
    with torch.no_grad():
        assert torch.equal(bn(x, _MASK),
                           MB.normalize_plain(x, factor, offset))
