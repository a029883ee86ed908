"""Model FLOPs of one train step of the PN-Transformer, from the config's
widths and the valid part counts of the step's batch.

Only valid parts count, never padded slots.  A matmul of m x k by k x n is
2 m k n FLOPs forward; its backward is twice that (the input's gradient
and the weight's), less the input's gradient where the input is data (the
encoder's first layer).  The encoder's five pointwise layers run on every
point of every valid part; the transformer's projections, attention and
feed-forward on each shape's valid tokens; the pose head on every valid
part, once for each MoN sample.  The chamfer counts CHAMFER_FLOPS a point
pair (both directions from one distance, the pair once): the whole-shape
pairs and the part-to-same-part pairs, once for each MoN sample and
supervised iteration.  Nothing recomputed is counted, and neither is the
semantic matching's cost, which is no model work.
"""

ENCODER_DIMS = (3, 64, 64, 64, 128)
HEAD_DIMS = (256, 128)
CHAMFER_FLOPS = 8


def _mm(m, k, n):
    return 2 * m * k * n


def label_dim(cfg):
    d = cfg['data']
    if d['dataset'] == 'geometry':
        return 0
    return int(d['max_num_part']) + (
        int(d['num_part_category']) if 'part_label' in d['data_keys'] else 0)


def model_flops(cfg, counts):
    """Forward plus backward FLOPs of the trained matmuls for a batch whose
    shapes have `counts` valid parts."""
    m, lc = cfg['model'], cfg['loss']
    N = int(cfg['data']['num_pc_points'])
    C = int(m['pc_feat_dim'])
    F = int(m['transformer_feat_dim'])
    L = int(m['transformer_layers'])
    S = int(lc.get('sample_iter', 1))
    parts = sum(counts)
    dims = ENCODER_DIMS + (C, )
    enc = sum(_mm(N * parts, a, b) for a, b in zip(dims[:-1], dims[1:]))
    enc_bwd = 2 * enc - _mm(N * parts, dims[0], dims[1])
    tr = 0
    for n in counts:
        per_layer = (_mm(n, C, 3 * C) + 2 * _mm(n, C, n) + _mm(n, C, C)
                     + _mm(n, C, F) + _mm(n, F, C))
        tr += L * per_layer
    head_in = C + label_dim(cfg) + int(lc.get('noise_dim', 0))
    h = HEAD_DIMS
    head = (_mm(parts, head_in, h[0]) + _mm(parts, h[0], h[1])
            + _mm(parts, h[1], 4) + _mm(parts, h[1], 3))
    return enc + enc_bwd + 3 * tr + 3 * S * head


def chamfer_pairs(cfg, counts):
    """Point pairs of one step's chamfers (whole shape and part to part),
    summed over the MoN samples."""
    N = int(cfg['data']['num_pc_points'])
    S = int(cfg['loss'].get('sample_iter', 1))
    return S * sum((n * N) ** 2 + n * N * N for n in counts)


def step_flops(cfg, counts):
    return model_flops(cfg, counts) + CHAMFER_FLOPS * chamfer_pairs(cfg,
                                                                    counts)
