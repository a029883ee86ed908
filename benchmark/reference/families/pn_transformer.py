"""The PN-Transformer (PointNet encoder, transformer over the parts, pose
head; reference/model.py) as a reference family: PointNet and the
quaternion head, one supervised iteration a sample."""

from ...harness.flops import label_dim, mm
from ..model import PNTransformer

ENCODER_DIMS = (3, 64, 64, 64, 128)
HEAD_DIMS = (256, 128)


def supported(cfg):
    m = cfg['model']
    if m['encoder'] != 'pointnet' or m['rot_type'] != 'quat':
        raise ValueError('the reference is the PN-Transformer with PointNet '
                         'and the quaternion head')


def build(params, cfg, prec):
    return PNTransformer(params, cfg, prec)


def iterations(cfg):
    return 1


def model_flops(cfg, counts):
    """The encoder's five pointwise layers on every point of every valid
    part; the transformer's projections, attention and feed-forward on
    each shape's valid tokens; the pose head on every valid part, once for
    each MoN sample."""
    m, lc = cfg['model'], cfg['loss']
    N = int(cfg['data']['num_pc_points'])
    C = int(m['pc_feat_dim'])
    F = int(m['transformer_feat_dim'])
    L = int(m['transformer_layers'])
    S = int(lc.get('sample_iter', 1))
    parts = sum(counts)
    dims = ENCODER_DIMS + (C, )
    enc = sum(mm(N * parts, a, b) for a, b in zip(dims[:-1], dims[1:]))
    enc_bwd = 2 * enc - mm(N * parts, dims[0], dims[1])
    tr = 0
    for n in counts:
        per_layer = (mm(n, C, 3 * C) + 2 * mm(n, C, n) + mm(n, C, C)
                     + mm(n, C, F) + mm(n, F, C))
        tr += L * per_layer
    head_in = C + label_dim(cfg) + int(lc.get('noise_dim', 0))
    h = HEAD_DIMS
    head = (mm(parts, head_in, h[0]) + mm(parts, h[0], h[1])
            + mm(parts, h[1], 4) + mm(parts, h[1], 3))
    return enc + enc_bwd + 3 * tr + 3 * S * head
