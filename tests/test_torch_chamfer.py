"""The port's part-structured chamfer against the JAX package.

The same numpy clouds go through `multi_part_assembly_tpu.ops.chamfer`
(CPU backend; fused mode 'force' runs the Pallas kernels B1-B4 in interpret
mode, 'off' the unfused route's jnp fallback `_nn_parts_ref`) and through
the port, which on CPU tensors takes the plain versions of its route: the
fused route's (B1-B4) under 'auto', the unfused route's (B8) under 'off'.
Every pairing of the two packages' modes is held to the same tolerances:
distances atol 1e-5 (the JAX kernels form |x|^2 + |y|^2 - 2x.y from a
matmul, the port (dx^2 + dy^2) + dz^2; both f32-accurate on unit-scale
clouds); gradients atol 1e-4, rtol 1e-4.  Witness numbering differs
between the fused routes (JAX pads each part to 128 lanes), so witnesses
are checked against the port's own distances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_part_assembly_tpu.ops import chamfer as JC
from multi_part_assembly_tpu_torch.ops import chamfer as TC
from multi_part_assembly_tpu_torch.utils import tracing

torch.set_num_threads(2)

CASES = {
    'mixed': (5, 40, [2, 5, 3]),
    'all_valid': (5, 40, [5, 5, 5]),
    'single_part': (5, 40, [1, 1, 2]),
    'multigroup_3_7': (10, 40, [3, 7]),
    'multigroup_10_2': (10, 40, [10, 2]),
    'multigroup_6_10': (10, 40, [6, 10]),
}


# (JAX mode, port mode); the ids of the port's fused route stay the JAX
# mode's alone
MODES = {'force': ('force', 'auto'), 'off': ('off', 'auto'),
         'force-port_off': ('force', 'off'), 'off-port_off': ('off', 'off')}


@pytest.fixture(params=sorted(MODES))
def fused_mode(request):
    jax_mode, port_mode = MODES[request.param]
    JC.set_fused_mode(jax_mode)
    TC.set_fused_mode(port_mode)
    yield jax_mode
    JC.set_fused_mode('auto')
    TC.set_fused_mode('auto')


def _inputs(case, seed=0):
    P, N, nparts = CASES[case]
    rng = np.random.RandomState(seed)
    B = len(nparts)
    x = rng.randn(B, P, N, 3).astype(np.float32)
    y = rng.randn(B, P, N, 3).astype(np.float32)
    valids = (np.arange(P)[None] <
              np.asarray(nparts)[:, None]).astype(np.float32)
    w1 = rng.rand(B, P, N).astype(np.float32)
    w2 = rng.rand(B, P, N).astype(np.float32)
    return x, y, valids, w1, w2


_JITTED = {}


def _jax(mode, name, x, y, valids, w1, w2):
    """Distances and gradients from the JAX package, jitted once per (fused
    mode, function): the mode is read when the function is traced."""
    key = (mode, name)
    if key not in _JITTED:
        fn = getattr(JC, name)

        def run(a, b, v, c1, c2):
            def loss(a, b):
                d1, d2 = fn(a, b, v)
                return jnp.sum(d1 * c1.reshape(d1.shape)) + \
                    jnp.sum(d2 * c2.reshape(d2.shape))
            return fn(a, b, v) + jax.grad(loss, (0, 1))(a, b)

        _JITTED[key] = jax.jit(run)
    return [np.asarray(v) for v in _JITTED[key](x, y, valids, w1, w2)]


def _torch(fn, x, y, valids, w1, w2):
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    d1, d2 = fn(xt, yt, torch.tensor(valids))
    loss = (d1 * torch.tensor(w1).reshape(d1.shape)).sum() + \
        (d2 * torch.tensor(w2).reshape(d2.shape)).sum()
    loss.backward()
    return [v.detach().numpy() for v in (d1, d2, xt.grad, yt.grad)]


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('name', ['chamfer_parts', 'chamfer_diag'])
def test_distances_and_grads_match_jax(fused_mode, case, name):
    args = _inputs(case)
    ref = _jax(fused_mode, name, *args)
    tracing.reset()
    ours = _torch(getattr(TC, name), *args)
    for r, o in zip(ref[:2], ours[:2]):
        np.testing.assert_allclose(o, r, atol=1e-5, rtol=0)
    for r, o in zip(ref[2:], ours[2:]):
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-4)
    # CPU tensors take the plain versions: no kernel launched
    assert not any(k.startswith('launch.') for k in tracing.counters())


# backward variants of the fused route: (weight d1, weight d2, y needs a
# gradient, every y part collapsed to one point)
GRAD_VARIANTS = {
    'no_dy': (True, True, False, False),
    'g1_none': (False, True, True, False),
    'g2_none': (True, False, True, False),
    'collapsed': (True, True, True, True),
}


@pytest.mark.parametrize('variant', sorted(GRAD_VARIANTS))
@pytest.mark.parametrize('name', ['chamfer_parts', 'chamfer_diag'])
@pytest.mark.parametrize('jax_mode', ['force', 'off'])
def test_grad_variants_match_jax(monkeypatch, jax_mode, name, variant):
    """The fused route's backward (B2/B4's plain version on the CPU)
    against the JAX package: without dy, with an unused distance (whose
    cotangent reaches the backward as None, and counts as zeros in JAX),
    and with every y part collapsed to one point, so that one witness takes
    a whole part's weight.  The cotangents are nonzero at padded parts, whose
    gradients must still be exactly 0."""
    use1, use2, need_dy, collapse = GRAD_VARIANTS[variant]
    x, y, valids, w1, w2 = _inputs('mixed')
    if collapse:
        y = np.ascontiguousarray(np.broadcast_to(y[:, :, :1], y.shape))
    w1, w2 = w1 * use1, w2 * use2
    JC.set_fused_mode(jax_mode)
    try:
        ref = _jax(jax_mode, name, x, y, valids, w1, w2)
    finally:
        JC.set_fused_mode('auto')

    calls = []
    plain = TC.chamfer_grad_plain

    def spy(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(TC, 'chamfer_grad_plain', spy)
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=need_dy)
    d1, d2 = getattr(TC, name)(xt, yt, torch.tensor(valids))
    loss = 0.0
    if use1:
        loss = loss + (d1 * torch.tensor(w1).reshape(d1.shape)).sum()
    if use2:
        loss = loss + (d2 * torch.tensor(w2).reshape(d2.shape)).sum()
    loss.backward()

    (*_, g1, g2, diagonal, need) = calls[0]
    assert len(calls) == 1 and diagonal == (name == 'chamfer_diag')
    assert (g1 is None) != use1 and (g2 is None) != use2
    assert need == need_dy and (yt.grad is None) != need_dy
    for r, o in zip(ref[:2], (d1, d2)):
        np.testing.assert_allclose(o.detach().numpy(), r, atol=1e-5, rtol=0)
    grads = [xt.grad] + ([yt.grad] if need_dy else [])
    pad = torch.tensor(valids) == 0
    for r, o in zip(ref[2:], grads):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-4, rtol=1e-4)
        assert (o[pad] == 0).all()


@pytest.mark.parametrize('diagonal', [False, True])
def test_plain_grad_contract(diagonal):
    """`chamfer_grad_plain`: no dy unless asked for, and the same dx either
    way; a None cotangent equals a zero one; exact zeros at padded parts
    whatever their cotangents."""
    x, y, valids, w1, w2 = (torch.tensor(v) for v in _inputs('mixed'))
    n_parts = valids.sum(1).to(torch.int32)
    _, _, i1, i2 = TC.nn_pair_plain(x, y, n_parts, diagonal)
    args = (x, y, n_parts, i1, i2)
    dx, dy = TC.chamfer_grad_plain(*args, w1, w2, diagonal, True)
    dx_only, none = TC.chamfer_grad_plain(*args, w1, w2, diagonal, False)
    assert none is None and torch.equal(dx_only, dx)
    zero = torch.zeros_like(w1)
    for g1, g2 in ((None, w2), (w1, None), (None, None)):
        got = TC.chamfer_grad_plain(*args, g1, g2, diagonal, True)
        want = TC.chamfer_grad_plain(*args, zero if g1 is None else g1,
                                     zero if g2 is None else g2, diagonal,
                                     True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    pad = valids == 0
    assert (w1[pad] != 0).all()
    assert (dx[pad] == 0).all() and (dy[pad] == 0).all()
    assert dx[~pad].abs().sum() > 0 and dy[~pad].abs().sum() > 0


def test_chamfer_pairs_matches_jax(fused_mode):
    """Each pair a one-part shape; invalid pairs give 0 and no gradient."""
    x, y, _, w1, w2 = _inputs('multigroup_6_10')
    M = 7
    x, y = x[0, :M], y[0, :M]
    w1, w2 = w1[0, :M], w2[0, :M]
    pv = np.asarray([1, 0, 1, 1, 0, 1, 1], np.float32)
    ref = _jax(fused_mode, 'chamfer_pairs', x, y, pv, w1, w2)
    ours = _torch(TC.chamfer_pairs, x, y, pv, w1, w2)
    for r, o in zip(ref[:2], ours[:2]):
        np.testing.assert_allclose(o, r, atol=1e-5, rtol=0)
    for r, o in zip(ref[2:], ours[2:]):
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-4)
    for o in ours:
        assert (o[pv == 0] == 0).all()


@pytest.mark.parametrize('diagonal', [False, True])
def test_padded_parts_give_zero_and_no_witness(diagonal):
    x, y, valids, _, _ = _inputs('mixed')
    d1, d2, w1, w2 = TC.chamfer_witnesses(
        torch.tensor(x), torch.tensor(y), torch.tensor(valids),
        diagonal=diagonal)
    pad = torch.tensor(valids) == 0
    assert (d1[pad] == 0).all() and (d2[pad] == 0).all()
    assert (w1[pad] == -1).all() and (w2[pad] == -1).all()
    assert (w1[~pad] >= 0).all() and (w2[~pad] >= 0).all()


@pytest.mark.parametrize('case', ['mixed', 'multigroup_6_10'])
def test_plain_witness_is_the_minimum(case):
    """Each distance equals |x - y_w|^2 at its own witness, computed the
    kernel's way, and no valid target point is closer."""
    x, y, valids, _, _ = _inputs(case)
    d1, w1, _, _ = TC.chamfer_parts_ref(
        torch.tensor(x), torch.tensor(y), torch.tensor(valids))
    B, P, N, _ = x.shape
    yf = y.reshape(B, P * N, 3)
    for b in range(B):
        n = int(valids[b].sum()) * N
        xb = x[b].reshape(P * N, 3)[:n]
        diff = xb - yf[b, w1[b, :n].numpy()]
        dw = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + \
            diff[:, 2] * diff[:, 2]
        np.testing.assert_array_equal(d1[b, :n].numpy(), dw)
        full = ((xb[:, None] - yf[b, None, :n])**2).sum(-1)
        assert (full.min(1) >= d1[b, :n].numpy() - 1e-6).all()


def test_first_hit_tie():
    """Exact ties go to the smallest flat index, and the whole gradient to
    that witness (tests/test_fused_chamfer.py::test_fused_bwd_tie_first_hit
    on the port, held against the JAX fused kernel)."""
    B, P, N = 1, 2, 8
    x = np.zeros((B, P, N, 3), np.float32)
    x[0, :, :, 0] = np.arange(N) * 10.0
    x[0, 1, :, 1] = 1000.0
    y = np.copy(x)
    y[0, 0, 0] = x[0, 0, 0] + [1.0, 0, 0]
    y[0, 0, 1] = x[0, 0, 0] - [1.0, 0, 0]
    valids = np.ones((B, P), np.float32)
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    d1, _ = TC.chamfer_parts(xt, yt, torch.tensor(valids))
    d1[0, 0].backward()
    gy = yt.grad.numpy().reshape(P * N, 3)
    np.testing.assert_allclose(gy[0], [2.0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(gy[1], [0.0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy()[0, 0, 0], [-2.0, 0, 0],
                               atol=1e-6)
    _, w1, _, _ = TC.chamfer_parts_ref(xt, yt, torch.tensor(valids))
    assert int(w1[0, 0]) == 0

    JC.set_fused_mode('force')
    try:
        def loss(a, b):
            return JC.chamfer_parts(a, b, jnp.asarray(valids))[0][0, 0]
        gx_j, gy_j = jax.jit(jax.grad(loss, (0, 1)))(x, y)
    finally:
        JC.set_fused_mode('auto')
    np.testing.assert_allclose(gy, np.asarray(gy_j).reshape(P * N, 3),
                               atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-4)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA launchers never fall back: a CPU tensor is refused."""
    x = torch.zeros((1, 2, 4, 3))
    n_parts = torch.tensor([2], dtype=torch.int32)
    for diagonal in (False, True):
        with pytest.raises(ValueError, match='CUDA'):
            TC.nn_pair_cuda(x, x, n_parts, diagonal)
    w = torch.zeros((1, 2, 4), dtype=torch.int32)
    for diagonal in (False, True):
        with pytest.raises(ValueError, match='CUDA'):
            TC.chamfer_grad_cuda(x, x, n_parts, w, w, w.float(), None,
                                 diagonal, need_dy=True)


def test_unsupported_device_raises():
    x = torch.zeros((1, 2, 4, 3), device='meta')
    with pytest.raises(ValueError, match='no chamfer kernel'):
        TC.chamfer_parts(x, x, torch.ones((1, 2), device='meta'))


@pytest.mark.parametrize('keep', [False, True])
@pytest.mark.parametrize('diagonal', [False, True])
def test_plain_cpu_blocks_match_one_block(monkeypatch, diagonal, keep):
    """The CPU's small row blocks, its part-at-a-time diagonal and its
    in-place squared distances give the distances and witnesses of one
    block of the out-of-place ops (the card's form), bit for bit, ties
    included."""
    x, y, valids, _, _ = (torch.from_numpy(a)
                          for a in _inputs('multigroup_6_10'))
    x[:, 1] = x[:, 0]  # whole parts of tied distances
    y[:, 2, :20] = y[:, 2, 20:]
    n_parts = valids.sum(1).int()
    mask = None
    if keep and not diagonal:
        mask = torch.from_numpy(np.random.RandomState(3).rand(
            *valids.shape, valids.shape[1]) < 0.6)
    got = TC.nn_pair_plain(x, y, n_parts, diagonal, mask)
    monkeypatch.setattr(TC, '_PLAIN_ROWS_CPU', 10**9)
    with torch.enable_grad():  # the out-of-place ops
        xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
        want = TC.nn_pair_plain(xg, yg, n_parts, diagonal, mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w.detach())
