"""The port's DGCNN and PointNet++ (SSG, MSG) encoders against the JAX
package and the torch reference's goldens.

The same numpy inputs from a seed go through both sides; JAX pinned to
f32, weights carried by convert.py.  Where DGCNN builds a kNN graph in
feature space, a neighbour at the k-th distance can flip on an ulp between
two matmul routes: the port's graph is recorded and JAX is handed the same
(`_jax_knn_from`, a patch of the JAX encoders module's `knn` for the test's
length).  FPS and ball query need no such help on the CPU: their indices
are JAX's exactly (tests/test_torch_sampling.py).

Tolerances:
  - goldens (eval mode): atol 3e-4, rtol 1e-4, tests/test_golden_forward.py's;
  - train mode against JAX: outputs atol 1e-4, rtol 1e-4; every
    parameter's gradient within 1e-4 relative L2 plus twice the port
    gradient's own movement when the clouds move by a relative 1e-7 and
    1e-6, the graph and the ball sets held fixed (`_resolution`).  Nine
    batch norms over the batch's statistics, each a division by a standard
    deviation as small as 0.03, then ReLU and max-pool routing, make the
    train-mode PointNet++ gradient ill-conditioned: two correct f32
    implementations differ in it by about 1e-3 at this size (either stays
    within about 5e-7 of an f64 evaluation of a shared MLP's forward);
    the running statistics after one forward and backward atol 1e-5, rtol
    1e-4, which a second update by PointNet++'s recompute would break by
    about a tenth of their movement;
  - DGCNN collapsed against the reference-shaped naive path, the same
    graph: outputs and running statistics within 2e-4 (as JAX's
    tests/test_models.py:243), gradients 2e-4 relative L2.
Every family with each encoder: tests/test_torch_encoder_families.py.
"""

import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_parity as U
from multi_part_assembly_tpu.models.modules import encoders as JE
from multi_part_assembly_tpu_torch.models.convert import jax_to_state_dict
from multi_part_assembly_tpu_torch.models.modules import encoders as TE
from multi_part_assembly_tpu_torch.ops import knn as TK
from multi_part_assembly_tpu_torch.ops import sampling as TS

torch.set_num_threads(2)

ARCHS = ('dgcnn', 'pointnet2_ssg', 'pointnet2_msg')
FEAT = 16


@pytest.fixture(scope='module', autouse=True)
def _f32_no_dropout():
    with U.jax_f32_no_dropout():
        yield


@contextlib.contextmanager
def _jax_knn_from(indices):
    """The JAX encoders' `knn` returns these indices, in order."""
    queue = [jnp.asarray(np.asarray(i), jnp.int32) for i in indices]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JE, 'knn', lambda x, k, rows_per_block=None:
                   queue.pop(0))
        yield queue


@contextlib.contextmanager
def _indices(graph=(), fps=(), ball=(), record=False):
    """The port's kNN / FPS / ball-query results given (and recorded)."""
    TK.set_knn_override(list(graph), record=record)
    TS.set_sampling_override(list(fps), list(ball), record=record)
    try:
        yield TK.knn_calls(), TS.sampling_calls()
    finally:
        TK.set_knn_override()
        TS.set_sampling_override()


# ---------------------------------------------------------------------------
# goldens of the torch reference, eval mode
# ---------------------------------------------------------------------------

def test_golden_dgcnn_loads_by_name():
    """The reference's DGCNN state_dict (each EdgeConv BN under bn{i} and
    conv{i}.1) loads by name, strictly, and gives its features."""
    g = U.golden()
    sd = {k[len('dgc.'):]: torch.tensor(v) for k, v in g.items()
          if k.startswith('dgc.')}
    enc = TE.DGCNN(g['dgc.out_fc.weight'].shape[0])
    enc.load_state_dict(sd, strict=True)
    Bg, Pg, Ng, _ = g['part_pcs'].shape
    mask = g['valids'].reshape(-1) > 0
    flat = torch.tensor(g['part_pcs'].reshape(Bg * Pg, Ng, 3)[mask])
    with torch.no_grad():
        out = enc.eval()(flat)
    np.testing.assert_allclose(out.numpy(), g['dgc_feats'], atol=3e-4,
                               rtol=1e-4)


@pytest.mark.parametrize('arch,tag,scales', [('pointnet2_ssg', 'p2s', 1),
                                             ('pointnet2_msg', 'p2m', 3)])
def test_golden_pointnet2(arch, tag, scales):
    """The golden's shared MLPs, mapped to the JAX tree as
    tests/test_golden_forward.py maps them, carried by convert.py."""
    from test_golden_forward import _map_pointnet2
    g = U.golden()
    params, stats = _map_pointnet2(g, tag, scales)
    enc = TE.build_encoder(arch, g[f'{tag}_feats'].shape[1])
    enc.load_state_dict(jax_to_state_dict(
        {'params': params, 'batch_stats': stats}, 'encoder'), strict=True)
    with torch.no_grad():
        out = enc.eval()(torch.tensor(g['p2_pcs']))
    np.testing.assert_allclose(out.numpy(), g[f'{tag}_feats'], atol=3e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# each encoder in train mode against JAX
# ---------------------------------------------------------------------------

def _clouds(arch):
    """DGCNN: four clouds of 48 points, the third padded (zeros, mask 0);
    PointNet++: a cloud of 600 points, more than its first FPS takes, and
    a padded one."""
    rng = np.random.RandomState(0)
    if arch == 'dgcnn':
        x, mask = rng.randn(4, 48, 3), np.array([1, 1, 0, 1], np.float32)
    else:
        x, mask = rng.randn(2, 600, 3), np.array([1, 0], np.float32)
    return (0.4 * x * mask[:, None, None]).astype(np.float32), mask


def _jax_init(enc, x, mask):
    """JAX variables (jitted init) as numpy, non-trivial running
    statistics."""
    var = jax.jit(lambda a, m: enc.init(jax.random.PRNGKey(1), a, m,
                                        train=False))(x, mask)
    var = jax.tree_util.tree_map(np.asarray, var)
    return U.randomize_stats({k: dict(v) for k, v in var.items()}, 8)


@functools.lru_cache(maxsize=None)
def _jax_train(arch):
    """JAX variables, and one train-mode forward with the gradient of
    sum(out * cot): outputs, gradients, new running statistics; DGCNN on
    the port's recorded graph (returned)."""
    x, mask = _clouds(arch)
    enc = JE.build_encoder(arch, FEAT)
    var = _jax_init(enc, jnp.asarray(x), jnp.asarray(mask))
    cot = np.random.RandomState(2).randn(len(mask), FEAT).astype(np.float32)
    graph = []
    if arch == 'dgcnn':
        net = _port(arch, var)
        with _indices(record=True) as (calls, _):
            net.train()(torch.tensor(x), torch.tensor(mask))
        graph = list(calls)

    def f(params):
        out, new = enc.apply({'params': params,
                              'batch_stats': var['batch_stats']},
                             jnp.asarray(x), jnp.asarray(mask), train=True,
                             mutable=['batch_stats'])
        return jnp.sum(out * cot), (out, new['batch_stats'])
    with _jax_knn_from(graph) if graph else contextlib.nullcontext():
        (_, (out, stats)), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(var['params'])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return var, x, mask, cot, graph, np.asarray(out), to_np(grads), \
        to_np(stats)


def _port(arch, var, **kw):
    net = TE.build_encoder(arch, FEAT) if not kw else TE.DGCNN(FEAT, **kw)
    net.load_state_dict(jax_to_state_dict(var, 'encoder'), strict=True)
    return net


def _port_train(net, x, mask, cot, graph=(), **given):
    """One train-mode forward and backward of sum(out * cot): (outputs,
    gradients, state_dict); `graph` and `given` (fps=, ball=) hand the
    port its indices."""
    with _indices(graph, **given):
        net.train().zero_grad(set_to_none=True)
        out = net(torch.tensor(x), torch.tensor(mask))
        (out * torch.tensor(cot)).sum().backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    return out.detach().numpy(), grads, net.state_dict()


def _resolution(net, x, mask, cot, graph=()):
    """_port_train's result on `net`, and its gradient's `movement` when
    the clouds move by a relative 1e-7 and 1e-6 in a fixed random
    direction, every kNN graph, FPS sample and ball set held at the
    unmoved clouds' (on copies of `net`)."""
    nets = [copy.deepcopy(net), copy.deepcopy(net)]
    with _indices(graph, record=True) as (knn_calls, sampling):
        result = _port_train(net, x, mask, cot, graph)
        given = dict(graph=list(knn_calls), fps=list(sampling['fps']),
                     ball=list(sampling['ball']))
    d = np.random.RandomState(99).randn(*x.shape)
    moved = [_port_train(copied, (x * (1 + eps * d)).astype(np.float32),
                         mask, cot, **given)[1]
             for eps, copied in zip((1e-7, 1e-6), nets)]
    return result, movement(result[1], moved)


def movement(base, moved):
    """The largest relative L2 distance of any parameter's gradient in
    `moved` (a list of {name: gradient}) from `base`'s; a gradient whose
    norm is below 1e4 times the floor of
    torch_family_parity.assert_gradients_match counts relative to that."""
    floor = 1e-6 * np.linalg.norm(np.concatenate(
        [g.numpy().ravel() for g in base.values()]))
    return max(float(np.linalg.norm(g[n].numpy() - r.numpy())) /
               max(float(np.linalg.norm(r.numpy())), 1e4 * floor)
               for g in moved for n, r in base.items())


def _running(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(('running_mean', 'running_var'))}


@pytest.mark.parametrize('arch', ARCHS)
def test_train_step_matches_jax(arch):
    """Outputs, every gradient, and the running statistics after one
    forward and backward: PointNet++'s backward recomputes each grouped
    region under frozen statistics, so they move once, as JAX's."""
    var, x, mask, cot, graph, ref_out, ref_grads, ref_stats = \
        _jax_train(arch)
    net = _port(arch, var)
    before = {k: v.clone() for k, v in _running(net.state_dict()).items()}
    (out, grads, sd), movement = _resolution(net, x, mask, cot, graph)
    tol = 1e-4 + 2 * movement
    np.testing.assert_allclose(out, ref_out, atol=1e-4, rtol=1e-4)
    U.assert_gradients_match(grads, jax_to_state_dict(
        {'params': ref_grads, 'batch_stats': ref_stats}, 'encoder'), tol)
    after = jax_to_state_dict({'params': var['params'],
                               'batch_stats': ref_stats}, 'encoder')
    for k, v in _running(sd).items():
        np.testing.assert_allclose(v.numpy(), after[k].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
        assert not torch.equal(v, before[k]), k


@pytest.mark.parametrize('arch', ARCHS)
def test_eval_forward_matches_jax(arch):
    var, x, mask, _, _, _, _, _ = _jax_train(arch)
    enc = JE.build_encoder(arch, FEAT)
    net = _port(arch, var).eval()
    with _indices(record=True) as (calls, _):
        with torch.no_grad():
            out = net(torch.tensor(x), torch.tensor(mask))
        graph = list(calls)
    with _jax_knn_from(graph) if arch == 'dgcnn' else \
            contextlib.nullcontext():
        ref = jax.jit(lambda v, a, m: enc.apply(v, a, m, train=False))(
            var, jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)


def test_dgcnn_collapsed_matches_naive():
    """The collapsed EdgeConv against the reference-shaped edge tensor, on
    the same graph, in train mode: outputs, running statistics, gradients;
    then in eval mode."""
    var, x, mask, cot, graph, _, _, _ = _jax_train('dgcnn')
    fast = _port('dgcnn', var)
    naive = _port('dgcnn', var, naive=True)
    out, grads, sd = _port_train(fast, x, mask, cot, graph)
    n_out, n_grads, n_sd = _port_train(naive, x, mask, cot, graph)
    np.testing.assert_allclose(out, n_out, atol=2e-4, rtol=2e-4)
    for k, v in _running(sd).items():
        np.testing.assert_allclose(v.numpy(), n_sd[k].numpy(), atol=2e-4,
                                   rtol=2e-4, err_msg=k)
    U.assert_gradients_match(grads, n_grads, 2e-4)
    with torch.no_grad():
        TK.set_knn_override(list(graph))
        a = fast.eval()(torch.tensor(x), torch.tensor(mask))
        TK.set_knn_override(list(graph))
        b = naive.eval()(torch.tensor(x), torch.tensor(mask))
        TK.set_knn_override()
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=2e-4)


def test_recompute_updates_running_statistics_once():
    """Forward and backward of a PointNet++ set abstraction move the
    running statistics exactly as the forward alone does."""
    var, x, mask, cot, _, _, _, _ = _jax_train('pointnet2_ssg')
    a, b = _port('pointnet2_ssg', var), _port('pointnet2_ssg', var)
    _, _, sd = _port_train(a, x, mask, cot)
    with torch.no_grad():
        b.train()(torch.tensor(x), torch.tensor(mask))
    for k, v in _running(sd).items():
        assert torch.equal(v, b.state_dict()[k]), k


def test_feature_propagation_matches_jax():
    rng = np.random.RandomState(3)
    unknown = rng.randn(2, 32, 3).astype(np.float32)
    known = rng.randn(2, 8, 3).astype(np.float32)
    kf = rng.randn(2, 8, 5).astype(np.float32)
    uf = rng.randn(2, 32, 4).astype(np.float32)
    fp = JE.FeaturePropagation(mlp=(16, 16))
    args = [jnp.asarray(a) for a in (unknown, known, uf, kf)]
    var = U.jax_init(fp, args[0], seed=4, method=None, known=args[1],
                     unknown_feats=args[2], known_feats=args[3],
                     train=False)
    ref, _ = fp.apply(var, *args, None, True, mutable=['batch_stats'])
    net = TE.FeaturePropagation(9, (16, 16))
    sd = {}
    for j in range(2):
        p = var['params']['mlp'][f'mlp{j}']['kernel']
        sd[f'mlp.{3 * j}.weight'] = torch.tensor(p.T)[:, :, None, None]
        bn = var['params']['mlp'][f'bn{j}']
        st = var['batch_stats']['mlp'][f'bn{j}']
        sd.update({f'mlp.{3 * j + 1}.weight': torch.tensor(bn['scale']),
                   f'mlp.{3 * j + 1}.bias': torch.tensor(bn['bias']),
                   f'mlp.{3 * j + 1}.running_mean': torch.tensor(st['mean']),
                   f'mlp.{3 * j + 1}.running_var': torch.tensor(st['var'])})
    net.load_state_dict(sd, strict=True)
    out = net.train()(*[torch.tensor(a) for a in (unknown, known, uf, kf)])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-4)
    gout = net(torch.tensor(unknown), None, torch.tensor(uf),
               torch.tensor(kf[:, :1]))
    assert gout.shape == (2, 32, 16)


@pytest.mark.parametrize('masked', [True, False])
def test_lean_batch_norm_matches_plain(masked):
    """MaskedBatchNorm(lean=True): the same forward arithmetic, the closed-
    form backward of the moments."""
    from multi_part_assembly_tpu_torch.models.modules.norm import \
        MaskedBatchNorm
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(3, 8, 5, 6).astype(np.float32))
    mask = torch.tensor([1.0, 0.0, 1.0])[:, None, None] if masked else None
    cot = torch.tensor(rng.randn(3, 8, 5, 6).astype(np.float32))
    from multi_part_assembly_tpu_torch.models.modules import norm
    outs = []
    chunks = norm._chunks
    assert len(chunks(x, elements=200)) == 3  # 240 elements a row
    for lean in (False, True):
        bn = MaskedBatchNorm(6, lean=lean).train()
        bn.weight.data.uniform_(0.5, 1.5, generator=torch.Generator()
                                .manual_seed(0))
        xg = x.clone().requires_grad_(True)
        with pytest.MonkeyPatch.context() as mp:  # one row a slice
            mp.setattr(norm, '_chunks', lambda a: chunks(a, elements=200))
            y = bn(xg, mask)
            (y * cot).sum().backward()
        outs.append((y.detach(), xg.grad, bn.running_mean, bn.running_var,
                     bn.weight.grad))
    for i in range(5):  # output, the input's gradient, running mean and
        #                 variance, the scale's gradient
        assert U.rel_l2(outs[1][i].numpy(), outs[0][i].numpy()) <= 1e-6
