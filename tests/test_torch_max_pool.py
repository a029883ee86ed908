"""The PointNet's max-pool (ops/max_pool.py, csrc/max_pool.cu).

On the CPU: the plain version `max_pool_plain` against the JAX package's
`jnp.max(x.astype(f32), -2)`, forward and VJP, bit for bit from the same
numpy inputs (bf16 and f32 clouds, ties made on purpose, a cloud whose
points are all equal as a padded cloud's, a negative cotangent giving -0.0
away from the ties); the PointNet's output and gradients bitwise the
expression it pooled with before the kernels; the CPU's route (plain,
nothing launched); the refusals of the kernels' wrapper.  JAX is
imported inside the tests that use it, so that the card can run the rest:

    python -m pytest tests/test_torch_max_pool.py --noconftest -q -m cuda

On the card (`cuda`, skipping without one): the kernels bit for bit
against the plain version on the card at the flagship's shapes (max, tie
count and dx, signed zeros and a NaN column included), the launch
counters `launch.pool_fwd` and `launch.pool_bwd`, a CUDA graph's replay
equal to the eager calls.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from multi_part_assembly_tpu_torch.models.modules import \
    encoders as TE  # noqa: E402
from multi_part_assembly_tpu_torch.ops import \
    max_pool as MP  # noqa: E402
from multi_part_assembly_tpu_torch.ops import \
    masked_bn as MB  # noqa: E402
from multi_part_assembly_tpu_torch.utils import tracing  # noqa: E402


@pytest.fixture
def jnp():
    pytest.importorskip('jax')
    import jax.numpy as jnp
    return jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _clouds(shape, seed=0, ties=True, padded=True, nan=False):
    """Clouds [..., N, C] as numpy f32 of bf16 values, cotangent g [..., C]
    f32 negative in its first half of channels: the first cloud on a
    coarse grid (many ties), the last cloud's points all equal (a padded
    cloud), optionally one column of the second cloud NaN."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    flat = x.reshape((-1, ) + shape[-2:])
    if ties:
        flat[0] = np.round(flat[0] * 2) / 2
    if padded:
        flat[-1] = flat[-1, :1]
    if nan:
        flat[1, 3:6, 5] = np.nan
    x = torch.from_numpy(flat.reshape(shape)).to(torch.bfloat16).float()
    g = rng.randn(*(shape[:-2] + shape[-1:])).astype(np.float32)
    g[..., :shape[-1] // 2] = -np.abs(g[..., :shape[-1] // 2])
    return x.numpy(), g


def _bits(t):
    t = t.detach().float() if t.dtype == torch.bfloat16 else t.detach()
    return t.contiguous().view(torch.int32)


def _pool_launches():
    """(forward, backward) launches counted since `tracing.reset()`."""
    c = tracing.counters()
    return c.get('launch.pool_fwd', 0), c.get('launch.pool_bwd', 0)


def _plain(x, g):
    """(out, tie count, dx) of the plain version by autograd."""
    xg = x.detach().clone().requires_grad_(True)
    out = MP.max_pool_plain(xg)
    out.backward(g)
    count = (x.float() == out.detach().unsqueeze(-2)).sum(-2)
    return out.detach(), count, xg.grad


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('case', ['ties', 'padded', 'random', 'pointnet'])
def test_plain_matches_jax_forward_and_vjp(jnp, dtype, case):
    """`max_pool_plain` and JAX's pool (JAX encoders.py `PointNet`:
    astype(f32), then max over the points) on the same clouds: output and
    input cotangent bit for bit, -0.0 where a negative cotangent meets a
    point that is not the max, g / N at every point of an all-equal
    cloud."""
    import jax
    shape = {'ties': (2, 3, 40, 16), 'padded': (1, 4, 25, 8),
             'random': (3, 17, 24), 'pointnet': (2, 5, 100, 64)}[case]
    x_np, g_np = _clouds(shape, seed=len(case), ties=case != 'random',
                         padded=case in ('padded', 'pointnet'))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = torch.from_numpy(x_np).to(tdt)
    out, _, dx = _plain(x, torch.from_numpy(g_np))
    xj = jnp.asarray(x_np).astype(jdt)
    jout, vjp = jax.vjp(lambda v: jnp.max(v.astype(jnp.float32), axis=-2),
                        xj)
    jdx, = vjp(jnp.asarray(g_np))
    assert torch.equal(_bits(out), torch.from_numpy(
        np.array(jout, np.float32)).view(torch.int32))
    assert torch.equal(_bits(dx), torch.from_numpy(
        np.array(jdx.astype(jnp.float32))).view(torch.int32))
    assert dx.dtype == tdt
    signed = torch.signbit(dx) & (dx == 0)
    assert signed.any()  # negative g, points that are not the max
    if case in ('padded', 'pointnet'):
        last = dx.reshape((-1, ) + shape[-2:])[-1].float()
        g_last = torch.from_numpy(g_np).reshape(-1, shape[-1])[-1]
        want = (g_last / torch.full_like(g_last, shape[-2])).to(tdt).float()
        assert torch.equal(last, want.expand_as(last))


def test_pointnet_is_the_parents_pool_bitwise(monkeypatch):
    """The PointNet on the CPU, train mode, bf16: output, input gradient,
    every parameter's gradient and the running statistics bitwise those of
    the same net pooling with `x.float().amax(dim=-2)`."""
    torch.manual_seed(0)
    net = TE.PointNet(32, compute_dtype=torch.bfloat16).train()
    x = torch.randn(2, 4, 50, 3)
    mask = torch.tensor([[1., 1., 0., 0.], [1., 1., 1., 0.]])
    cot = torch.randn(2, 4, 32)
    runs = []
    for parent in (False, True):
        if parent:
            monkeypatch.setattr(TE, 'max_pool',
                                lambda t: t.float().amax(dim=-2))
        model = TE.PointNet(32, compute_dtype=torch.bfloat16).train()
        model.load_state_dict(net.state_dict())
        xg = x.clone().requires_grad_(True)
        out = model(xg, mask)
        (out * cot).sum().backward()
        runs.append([out, xg.grad] + [p.grad for p in model.parameters()] +
                    list(model.buffers()))
    for a, b in zip(*runs):
        assert torch.equal(_bits(a) if a.is_floating_point() else a,
                           _bits(b) if b.is_floating_point() else b)


def test_cpu_takes_the_plain_route_and_counts_nothing():
    """On the CPU the pool is the plain version: no kernel launched (no
    `launch.pool_*` counted); a type or width the kernels refuse pools all
    the same (the refusals are the card's)."""
    net = TE.PointNet(16, compute_dtype=torch.bfloat16).train()
    tracing.reset()
    net(torch.randn(2, 4, 10, 3), torch.ones(2, 4)).sum().backward()
    for x in (torch.randn(2, 5, 12), torch.randn(2, 5, 16).half()):
        assert torch.equal(MP.max_pool(x), MP.max_pool_plain(x))
    assert not any(k.startswith('launch.pool_') for k in tracing.counters())


@pytest.mark.parametrize('name,x', [
    ('f16', torch.zeros(2, 5, 16, dtype=torch.float16)),
    ('f64', torch.zeros(2, 5, 16, dtype=torch.float64)),
    ('channels_not_8', torch.zeros(2, 5, 12, dtype=torch.bfloat16)),
    ('no_points', torch.zeros(2, 0, 16, dtype=torch.bfloat16)),
    ('no_clouds', torch.zeros(0, 5, 16, dtype=torch.bfloat16)),
    ('one_axis', torch.zeros(16, dtype=torch.bfloat16)),
    ('not_contiguous', torch.zeros(2, 16, 5, dtype=torch.bfloat16)
     .transpose(-1, -2)),
    ('misaligned', torch.zeros(8 * 17, dtype=torch.bfloat16)[1:1 + 8 * 16]
     .view(16, 8)),
])
def test_kernels_refuse_what_they_cannot_take(name, x):
    """A type, a width, an empty axis or a layout the kernels do not take
    raises before any launch (the wrapper passes `kernel_rows(x)`, so a
    strided or misaligned x reaches them as a contiguous, aligned copy)."""
    with pytest.raises(ValueError, match='expected contiguous'):
        MP._clouds(x)
    if name in ('not_contiguous', 'misaligned'):
        assert MP._clouds(MB.kernel_rows(x))[1:3] == tuple(x.shape[-2:])


def test_clouds_reads_the_kernels_shape():
    x = torch.zeros(3, 4, 7, 24, dtype=torch.bfloat16)
    assert MP._clouds(x) == (12, 7, 24, 1)
    assert MP._clouds(x.float()) == (12, 7, 24, 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# name -> (shape, dtype): the flagship's and RGL-Net's PointNet outputs at
# batch 32, an odd point count, and f32 clouds of a width under one row of
# lanes
CARD_CASES = {'flagship256': ((32, 20, 1000, 256), 'bfloat16'),
              'rgl_net128': ((32, 20, 1000, 128), 'bfloat16'),
              'odd_points': ((4, 7, 999, 64), 'bfloat16'),
              'f32': ((3, 5, 333, 40), 'float32')}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CARD_CASES))
def test_kernels_match_plain_bitwise(cuda, case):
    """The kernels against autograd of the plain version on the card: the
    max bit for bit (a NaN column's included), the tie count equal to
    (x == max) summed, dx bit for bit (-0.0 away from the ties under a
    negative g, NaN down a NaN column, g / N over an all-equal cloud); two
    runs bitwise equal."""
    shape, dtype = CARD_CASES[case]
    x_np, g_np = _clouds(shape, seed=7, nan=True)
    x = torch.from_numpy(x_np).to(cuda, getattr(torch, dtype))
    g = torch.from_numpy(g_np).to(cuda)
    runs = []
    for _ in range(2):
        out, count = MP.max_pool_cuda(x)
        runs.append((out, count, MP.max_pool_grad_cuda(x, out, count, g)))
    for a, b in zip(*runs):
        assert torch.equal(_bits(a) if a.is_floating_point() else a,
                           _bits(b) if b.is_floating_point() else b)
    out, count, dx = runs[0]
    p_out, p_count, p_dx = _plain(x, g)
    assert torch.equal(_bits(out), _bits(p_out))
    assert torch.equal(count.long(), p_count)
    assert torch.equal(_bits(dx), _bits(p_dx))
    assert dx.dtype == x.dtype and count.dtype == torch.int32
    assert torch.isnan(out).any() and (count == 0).any()
    assert (torch.signbit(dx) & (dx == 0)).any()
    assert int(count.max()) == shape[-2]  # the all-equal cloud


@pytest.mark.cuda
def test_routes_launches_and_counter_on_card(cuda):
    """The PointNet on the card pools on the kernels: one forward and one
    backward launch a train-mode call with its backward, one forward
    launch an eval-mode call; a strided x takes the
    kernels through a contiguous copy, the same output; a type or width the
    kernels do not take raises."""
    net = TE.PointNet(256, compute_dtype=torch.bfloat16).to(cuda)
    x = torch.randn(4, 20, 100, 3, device=cuda)
    mask = (torch.arange(20, device=cuda)[None] <
            torch.tensor([3, 20, 1, 7], device=cuda)[:, None]).float()
    tracing.reset()
    net.train()(x, mask).sum().backward()
    assert _pool_launches() == (1, 1)
    with torch.no_grad():
        net.eval()(x, mask)
    assert _pool_launches() == (2, 1)
    rows = torch.randn(2, 5, 16, 64, device=cuda).to(torch.bfloat16)
    strided = rows.transpose(-1, -2)
    assert torch.equal(MP.max_pool(strided),
                       MP.max_pool(strided.contiguous()))
    assert torch.equal(MP.max_pool(strided), MP.max_pool_plain(strided))
    for bad in (torch.randn(2, 5, 16, device=cuda).half(),
                torch.randn(2, 5, 12, device=cuda)):
        with pytest.raises(ValueError, match='expected contiguous'):
            MP.max_pool(bad)


@pytest.mark.cuda
def test_graph_replay_equals_eager(cuda):
    """The pool's forward and backward captured in a CUDA graph and
    replayed equal the same calls run eagerly: output and dx bitwise; the
    capture launches each kernel once."""
    x_np, g_np = _clouds((32, 20, 1000, 256), seed=3)
    x = torch.from_numpy(x_np).to(cuda, torch.bfloat16).requires_grad_(True)
    g = torch.from_numpy(g_np).to(cuda)

    def step():
        out = MP.max_pool(x)
        return (out, ) + torch.autograd.grad(out, x, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    tracing.reset()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    assert _pool_launches() == (1, 1)
    graph.replay()
    eager = step()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(_bits(a), _bits(b))
