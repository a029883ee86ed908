"""kNN graph and EdgeConv neighbourhood ops of DGCNN.

Port of multi_part_assembly_tpu/ops/knn.py.  Channels-last ([B, N, C])
throughout, as there.  None of these is a Pallas kernel in the JAX package
(kNN is a matmul and XLA's top_k, the gathers one-hot matmuls): they are
plain PyTorch here, on the card and on the CPU alike.

  - `knn(x, k, rows_per_block)`: the k nearest rows of every row, its own
    included, from the negative squared distance `2 x.y - |x|^2 - |y|^2`
    in exact f32 (no TF32) and `torch.topk`.  Blocking the query rows
    bounds the live Gram block to `[B, rows, N]` and gives the same
    indices as one block.  The slots come largest first; among equal
    distances `torch.topk` promises no order (JAX's `lax.top_k` puts the
    lower index first), so the port's neighbour SETS are JAX's, and their
    order within the k slots may differ where two distances tie.
  - `gather_rows` / `scatter_rows`: plain indexing; the one-hot matmul of
    JAX knn.py:76-99 is a TPU trick.  `scatter_rows` adds by
    `index_put_(accumulate=True)`, which on the card sorts the indices and
    adds each row's terms in a fixed order: run to run the same bits.
  - `neighborhood_reduce(u, idx, with_stats)`: max, min, sum and sum of
    squares of u over each row's neighbours (JAX :102-183), a
    `torch.autograd.Function` that never holds the `[B, N, K, C]` gathered
    tensor, in the forward or the backward.
  - `get_graph_feature`: the reference-shaped `[B, N, k, 2C]` edge
    features (naive DGCNN, tests).

`set_knn_override(list)` hands `knn` its results, consumed in order, one
a call: a hook for tests that compare two devices, where a neighbour at
the k-th distance can flip on an ulp.
"""

import torch

__all__ = ['knn', 'get_graph_feature', 'gather_rows', 'scatter_rows',
           'neighborhood_reduce', 'set_knn_override', 'knn_calls']

# test hook: knn's results, consumed in order; every result knn computes
# (or takes from the hook) is appended to _CALLS while recording
_OVERRIDE = []
_CALLS = None


def set_knn_override(results=None, record=False):
    """Give the next `knn` calls these index tensors (consumed in order),
    and/or start recording every call's result (`knn_calls()`)."""
    global _CALLS
    _OVERRIDE[:] = list(results or [])
    _CALLS = [] if record else None


def knn_calls():
    return _CALLS


def _knn_block(xq, xq2, x, x2, k):
    inner = torch.bmm(xq, x.transpose(1, 2))  # [B, rows, N]
    neg_dist = 2.0 * inner - xq2[:, :, None] - x2[:, None, :]
    return torch.topk(neg_dist, k, dim=-1).indices


def knn(x, k, rows_per_block=None):
    """[B, N, C] f32 -> [B, N, k] int64 indices of the k nearest rows (self
    included), largest negative distance first (JAX knn.py:44-73).
    `rows_per_block` (a divisor of N) blocks the query rows."""
    if _OVERRIDE:
        idx = _OVERRIDE.pop(0).to(x.device)
    else:
        if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError('knn needs exact f32 matmuls: turn TF32 off')
        with torch.profiler.record_function('knn'):
            x2 = (x * x).sum(-1)
            N = x.shape[1]
            if rows_per_block is None or rows_per_block >= N:
                idx = _knn_block(x, x2, x, x2, k)
            else:
                assert N % rows_per_block == 0, (N, rows_per_block)
                idx = torch.cat([
                    _knn_block(x[:, r:r + rows_per_block],
                               x2[:, r:r + rows_per_block], x, x2, k)
                    for r in range(0, N, rows_per_block)], dim=1)
    if _CALLS is not None:
        _CALLS.append(idx.cpu())
    return idx


def _batch_index(idx):
    """[B, 1] batch row index broadcasting against idx [B, M]."""
    return torch.arange(idx.shape[0], device=idx.device)[:, None]


def gather_rows(x, idx):
    """[B, N, C] x [B, M] -> [B, M, C]: out[b, m] = x[b, idx[b, m]]."""
    return x[_batch_index(idx), idx]


def scatter_rows(y, idx, n, out=None):
    """Transpose of `gather_rows`: out[b, j] += sum_{m: idx[b,m]=j} y[b, m]
    in f32 ([B, M, C] -> [B, n, C]); `out` (f32) accumulates in place."""
    if out is None:
        out = y.new_zeros((y.shape[0], n, y.shape[-1]), dtype=torch.float32)
    return out.index_put_((_batch_index(idx), idx), y.float(),
                          accumulate=True)


class _NeighborhoodReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u, idx, with_stats):
        B, N, C = u.shape
        mx = torch.full((B, N, C), -torch.inf, dtype=u.dtype, device=u.device)
        mn = torch.full((B, N, C), torch.inf, dtype=u.dtype, device=u.device)
        s = u.new_zeros((B, N, C), dtype=torch.float32)
        q = u.new_zeros((B, N, C), dtype=torch.float32)
        for ik in idx.unbind(2):
            g = gather_rows(u, ik)  # [B, N, C], exact in u's dtype
            torch.maximum(mx, g, out=mx)
            torch.minimum(mn, g, out=mn)
            if with_stats:
                gf = g.float()
                s += gf
                q += gf * gf
        ctx.with_stats = with_stats
        ctx.save_for_backward(u, idx, mx, mn)
        ctx.set_materialize_grads(False)
        if not with_stats:
            ctx.mark_non_differentiable(s, q)
        return mx.float(), mn.float(), s, q

    @staticmethod
    def backward(ctx, g_mx, g_mn, g_s, g_q):
        """Recompute each slot's gather; the max (min) cotangent goes to the
        FIRST slot in k order whose value equals the max (min), as JAX's
        `_nr_bwd` (knn.py:159-180) and torch's own max routing do."""
        u, idx, mx, mn = ctx.saved_tensors
        B, N, C = u.shape
        gu = u.new_zeros((B, N, C), dtype=torch.float32)
        cl_mx = torch.zeros((B, N, C), dtype=torch.bool, device=u.device)
        cl_mn = torch.zeros_like(cl_mx)
        stats = ctx.with_stats and (g_s is not None or g_q is not None)
        with torch.profiler.record_function('neighborhood_reduce_backward'):
            for ik in idx.unbind(2):
                g = gather_rows(u, ik)
                y = torch.zeros((B, N, C), dtype=torch.float32,
                                device=u.device)
                if g_mx is not None:
                    win = (g == mx) & ~cl_mx
                    y += torch.where(win, g_mx, 0.0)
                    cl_mx |= win
                if g_mn is not None:
                    win = (g == mn) & ~cl_mn
                    y += torch.where(win, g_mn, 0.0)
                    cl_mn |= win
                if stats:
                    if g_s is not None:
                        y += g_s
                    if g_q is not None:
                        y += 2.0 * g.float() * g_q
                scatter_rows(y, ik, N, out=gu)
        return gu.to(u.dtype), None, None


def neighborhood_reduce(u, idx, with_stats=True):
    """(mx, mn, s, q), each [B, N, C] f32: the max, min, sum and sum of
    squares of u [B, N, C] over each row's neighbours idx [B, N, K]
    (s = q = zeros when `with_stats` is False).  The core of the collapsed
    EdgeConv (models/modules/encoders.py DGCNN)."""
    return _NeighborhoodReduce.apply(u, idx, with_stats)


def get_graph_feature(x, k=20, idx=None, xq=None):
    """[B, Nq, k, 2C] edge features [x_j - x_i, x_i] of the k neighbours
    (JAX knn.py:186-209; the reference's [B, 2C, N, k] channels-last)."""
    if xq is None:
        xq = x
    B, Nq, C = xq.shape
    if idx is None:
        idx = knn(x, k)
    neighbors = gather_rows(x, idx.reshape(B, -1)).reshape(B, Nq, k, C)
    center = xq[:, :, None, :].expand(B, Nq, k, C)
    return torch.cat([neighbors - center, center], dim=-1)
