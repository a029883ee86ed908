"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: distances bit for bit and witnesses exactly (the kernel
computes the plain version's expression with every operation rounded on
its own); gradients within 1e-5 of the largest gradient, since the
backward's atomicAdds sum a witness's terms in a varying order.  The
sampling kernels' points bit for bit and their face draws exactly, for
the same reason.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from multi_part_assembly_tpu_torch.datasets import \
    device_sampler as TDS  # noqa: E402
from multi_part_assembly_tpu_torch.datasets.mesh_io import \
    MeshSampler  # noqa: E402
from multi_part_assembly_tpu_torch.ops import chamfer as TC  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _inputs(device, B=2, P=10, N=40, nparts=(6, 10), seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, P, N, 3).astype(np.float32)
    y = rng.randn(B, P, N, 3).astype(np.float32)
    valids = (np.arange(P)[None] <
              np.asarray(nparts)[:, None]).astype(np.float32)
    return [torch.tensor(v, device=device) for v in (x, y, valids)]


@pytest.mark.cuda
@pytest.mark.parametrize('diagonal', [False, True])
def test_kernels_match_plain(cuda, diagonal):
    x, y, valids = _inputs(cuda)
    kern = TC.chamfer_witnesses(x, y, valids, diagonal=diagonal)
    plain = TC.chamfer_witnesses(x, y, valids, diagonal=diagonal,
                                 plain=True)
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)
    weights = [torch.rand(kern[0].shape, device=cuda) for _ in range(2)]
    grads = []
    for plain_mode in (False, True):
        xt, yt = x.clone().requires_grad_(), y.clone().requires_grad_()
        d1, d2, _, _ = TC.chamfer_witnesses(xt, yt, valids,
                                            diagonal=diagonal,
                                            plain=plain_mode)
        ((d1 * weights[0]).sum() + (d2 * weights[1]).sum()).backward()
        grads.append((xt.grad, yt.grad))
    for k, p in zip(*grads):
        torch.testing.assert_close(k, p, atol=1e-5 * float(p.abs().max()),
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['chamfer_parts', 'chamfer_diag'])
def test_card_matches_cpu(cuda, name):
    """Kernel distances equal the CPU plain version's bit for bit."""
    fn = getattr(TC, name)
    on_card = fn(*_inputs(cuda))
    on_cpu = fn(*_inputs('cpu'))
    for k, c in zip(on_card, on_cpu):
        assert torch.equal(k.cpu(), c)


@pytest.mark.cuda
def test_launch_counters(cuda):
    """Each wrapper counts its own launches: one per direction."""
    x, y, valids = _inputs(cuda)
    x.requires_grad_()
    TC.reset_launches()
    d1, d2 = TC.chamfer_parts(x, y, valids)
    (d1.sum() + d2.sum()).backward()
    TC.chamfer_diag(x.detach(), y, valids)
    assert TC.LAUNCHES == {'nn_parts': 2, 'nn_diag': 2, 'bwd_parts': 2,
                           'bwd_diag': 0}


def _soup_tables(folder, layout, device, faces=(37, 512, 3000, 600)):
    """Sampling tables of random triangle soups whose face counts span
    sub-chunk, one-chunk and many-chunk pieces."""
    paths = []
    for i, nf in enumerate(faces):
        v = np.random.default_rng(i).normal(size=(nf * 3, 3))
        path = str(folder / f'soup{i}.obj')
        with open(path, 'w') as f:
            f.writelines(f'v {x} {y} {z}\n' for x, y, z in v)
            f.writelines(f'f {3 * j + 1} {3 * j + 2} {3 * j + 3}\n'
                         for j in range(nf))
        paths.append(path)
    return TDS.build_device_tables(paths, MeshSampler(), device=device,
                                   layout=layout)


def _sampler_inputs(device, n_pieces=4, K=50, N=1000, seed=0):
    rng = np.random.default_rng(seed)
    slots = torch.tensor(rng.integers(0, n_pieces, K), dtype=torch.int32,
                         device=device)
    u = torch.tensor(rng.random((K, 3, N), np.float32), device=device)
    return slots, u


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['dense', 'chunked'])
def test_sampler_kernels_match_plain(cuda, tmp_path, layout):
    tables = _soup_tables(tmp_path, layout, cuda)
    slots, u = _sampler_inputs(cuda)
    kern = TDS._sample_points(tables.table, tables.n_faces, slots, u,
                              return_draws=True)
    plain = TDS.sample_packed_ref(tables.table, tables.n_faces, slots, u,
                                  return_draws=True)
    on_cpu = TDS.sample_packed_ref(tables.table.cpu(), tables.n_faces.cpu(),
                                   slots.cpu(), u.cpu(), return_draws=True)
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)
    # the same draws on the CPU; its torch.sqrt differs from the card's
    # correctly rounded one in the last bit for some inputs
    assert torch.equal(kern[1].cpu(), on_cpu[1])
    torch.testing.assert_close(kern[0].cpu(), on_cpu[0], atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_sampler_layouts_agree_and_count(cuda, tmp_path):
    dense = _soup_tables(tmp_path, 'dense', cuda)
    chunk = _soup_tables(tmp_path, 'chunked', cuda)
    slots, u = _sampler_inputs(cuda, seed=1)
    TDS.reset_launches()
    pd = TDS._sample_points(dense.table, dense.n_faces, slots, u)
    pc = TDS._sample_points(chunk.table, chunk.n_faces, slots, u)
    assert torch.equal(pd, pc)
    assert TDS.LAUNCHES == {'sample_dense': 1, 'sample_chunked': 1}
    with pytest.raises(ValueError, match='uniforms'):
        TDS.sample_dense_cuda(dense.table, dense.n_faces, slots, u[:, :2])
