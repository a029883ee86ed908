"""RGL-Net as a reference family: "RGL-NET: A Recurrent Graph Learning
Framework for Progressive Part Assembly" (Narayan, Nagar, Raman; WACV
2022), as the configuration `configs/rgl_net/rgl_net-32x1-cosine_200e-
everyday.py` of `Wuziyi616/multi_part_assembly` states it: a PointNet
encoder (reference/model.py), then `gnn_iter` rounds, each supervised.

A round of a batch of B shapes in P part slots, features x [B, P, F]:
  relation   (from the second round) the pose encoder (7 -> 256 -> 128,
             ReLU each) on the last round's poses, the RelationNet
             (256 -> 256 -> 512 -> 1, ReLU, ReLU, sigmoid) on every pair
             [g_j, g_i] of pose features, times the valid pair matrix; in
             the first round the valid pair matrix itself;
  edge MLP   on every pair [x_i, x_j]: three linear layers (2F -> 512 ->
             512 -> F), each with a batch norm over all B x P x P pair rows
             and a ReLU; the relation-weighted mean over j;
  GRU        a bidirectional GRU (hidden 2F) over the valid parts of each
             shape in slot order, input [x_i, message_i]; each direction
             runs over the n valid parts only, the backward one from part
             n - 1 down, and a padded slot's output is zero;
  node MLP   4F -> 512 -> 512 -> F, a batch norm over all B x P slots after
             each layer, ReLU after the first two;
  pose head  on [x, labels, last poses] (reference/model.py `pose_head`).
The prediction is the rounds' poses stacked, [T, B, P, .].

Arithmetic: f32, with the values rounded to the compute type of
`exp.bf16` where the program rounds them (`Precision`): the operands and
results of the encoder's, the pair MLPs', the RelationNet's, the pose
encoder's, the node MLP's and the pose head's hidden matmuls, and each
batch norm's factor, offset and output.  The batch-norm statistics, the
relation-weighted mean and the GRU stay f32.  The GRU's initial hidden
states are drawn from `generator` in the program's order: each round, a
gaussian [1, 1, B, F] shared by both directions as the first half of the
state, then [1, 2, B, F], each direction's own second half.

Departures from the published description, all of them the reference
codebase's own: the parts run through the GRU in slot order (the data's
part order), not sorted; the GRU's initial hidden states are random, as
above; the batch norms of the edge and node MLPs count the padded pairs and
slots of the batch as rows; the relation net sees only the predicted poses.
Equivalent-part merging (`merge_node`) is the semantic configurations' and
is not written out.

Names are the program's (`edge_mlps.0.conv1.weight`, `grus.0.l0_d1.wi.weight`,
...): a GRU direction's `wi` packs the input projections of the gates
r|z|n with the r and z hidden biases merged in, `wh` the hidden
projections, `bhn` the n gate's hidden bias.
"""

import torch

from ...harness.flops import label_dim, mm
from ..model import batch_norm, pointnet, pose_head

ENCODER_DIMS = (3, 64, 64, 64, 128)
MLP_HIDDEN = 512
POSE_DIMS = (256, 128)
RELATION_DIMS = (256, 512, 1)
HEAD_DIMS = (256, 128)
POSE_DIM = 7  # quaternion and translation


def supported(cfg):
    m, lc = cfg['model'], cfg['loss']
    if m['encoder'] != 'pointnet' or m['rot_type'] != 'quat':
        raise ValueError('the reference is RGL-Net with PointNet and the '
                         'quaternion head')
    if m.get('merge_node', True):
        raise ValueError('the reference RGL-Net does not merge equivalent '
                         'parts: merge_node must be False')
    if int(lc.get('noise_dim', 0)):
        raise ValueError('the reference RGL-Net draws no head noise: '
                         'noise_dim must be 0')


def build(params, cfg, prec):
    return RGLNet(params, cfg, prec)


def iterations(cfg):
    return int(cfg['model']['gnn_iter'])


def model_flops(cfg, counts):
    """The encoder's five pointwise layers on every point of every valid
    part; a round's edge MLP on each shape's n x n valid pairs, its GRU on
    the n valid parts in each direction, node MLP and pose head on the
    valid parts; the pose encoder on the valid parts and the RelationNet
    on the valid pairs from the second round.  Backward twice the forward,
    less the input gradient of the encoder's first layer (the clouds) and
    of each GRU direction's first hidden step (the drawn initial state)."""
    m = cfg['model']
    N = int(cfg['data']['num_pc_points'])
    F = int(m['pc_feat_dim'])
    T = iterations(cfg)
    H = 2 * F
    parts = sum(counts)
    pairs = sum(n * n for n in counts)
    dims = ENCODER_DIMS + (F, )
    enc = sum(mm(N * parts, a, b) for a, b in zip(dims[:-1], dims[1:]))
    enc_bwd = 2 * enc - mm(N * parts, dims[0], dims[1])
    edge = (mm(pairs, 2 * F, MLP_HIDDEN) + mm(pairs, MLP_HIDDEN, MLP_HIDDEN)
            + mm(pairs, MLP_HIDDEN, F))
    r = RELATION_DIMS
    relation = (mm(parts, POSE_DIM, POSE_DIMS[0])
                + mm(parts, POSE_DIMS[0], POSE_DIMS[1])
                + mm(pairs, 2 * POSE_DIMS[1], r[0]) + mm(pairs, r[0], r[1])
                + mm(pairs, r[1], r[2]))
    gru = 2 * (mm(parts, 2 * F, 3 * H) + mm(parts, H, 3 * H))
    node = (mm(parts, 4 * F, MLP_HIDDEN) + mm(parts, MLP_HIDDEN, MLP_HIDDEN)
            + mm(parts, MLP_HIDDEN, F))
    h = HEAD_DIMS
    head = (mm(parts, F + label_dim(cfg) + POSE_DIM, h[0])
            + mm(parts, h[0], h[1]) + mm(parts, h[1], 4)
            + mm(parts, h[1], 3))
    rounds = T * (edge + gru + node + head) + (T - 1) * relation
    first_hidden = T * 2 * len(counts) * mm(1, H, 3 * H)
    return enc + enc_bwd + 3 * rounds - first_hidden


def mlp(params, prefix, x, prec, relu_last):
    """Three linear layers, each followed by a batch norm over every row
    (every axis but the last) and a ReLU (the last only if `relu_last`)."""
    for i in range(1, 4):
        x = prec.linear(x, params[f'{prefix}.conv{i}.weight'],
                        params[f'{prefix}.conv{i}.bias'])
        x = batch_norm(x, params[f'{prefix}.bn{i}.weight'],
                       params[f'{prefix}.bn{i}.bias'], prec)
        if i < 3 or relu_last:
            x = torch.relu(x)
    return x


def gru_direction(params, prefix, x, counts, h, reverse):
    """One GRU direction over each shape's valid parts, [B, P, C] ->
    [B, P, H], in f32.  `counts` [B] valid parts a shape; `h` [B, H] the
    initial state; `reverse` runs from part n - 1 down to part 0.  The
    state after a shape's last valid part is kept; padded slots read
    zero."""
    B, P, _ = x.shape
    t = torch.arange(P, device=x.device)[None].expand(B, P)
    valid = t < counts[:, None]
    # the slot each recurrent step reads: step s -> s, or n - 1 - s
    slot = torch.where(valid, counts[:, None] - 1 - t, t) if reverse else t
    xs = x.gather(1, slot[..., None].expand(x.shape))
    w_i = params[f'{prefix}.wi.weight']
    b_i = params[f'{prefix}.wi.bias']
    w_h = params[f'{prefix}.wh.weight']
    b_hn = params[f'{prefix}.bhn']
    gi = xs @ w_i.t() + b_i  # [B, P, 3H]
    outs = []
    for s in range(P):
        ir, iz, i_n = gi[:, s].chunk(3, dim=-1)
        hr, hz, hn = (h @ w_h.t()).chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(i_n + r * (hn + b_hn))
        new = (1.0 - z) * n + z * h
        live = valid[:, s, None]
        h = torch.where(live, new, h)
        outs.append(torch.where(live, new, torch.zeros_like(new)))
    out = torch.stack(outs, 1)
    # step s wrote the slot it read
    return out.new_zeros(out.shape).scatter(
        1, slot[..., None].expand(out.shape), out) if reverse else out


class RGLNet:
    """`precompute(batch)` -> the part features, valids and labels;
    `sample(feats, generator)` -> the stacked poses of the rounds
    ([T, B, P, 4], [T, B, P, 3]), drawing each round's GRU initial states
    from `generator`."""

    def __init__(self, params, cfg, prec):
        self.params = params
        self.prec = prec
        self.rounds = iterations(cfg)

    def precompute(self, batch):
        pcs, valids = batch['part_pcs'], batch['part_valids']
        B, P = valids.shape
        valid = valids > 0
        enc = pointnet(self.params, pcs[valid], self.prec)
        feats = enc.new_zeros((B, P, enc.shape[-1]))
        feats[valid] = enc
        labels = torch.cat([batch['part_label'], batch['instance_label']],
                           -1)
        return {'feats': feats, 'valids': valids, 'labels': labels}

    def _relation(self, pose, pair_valid):
        p, prec = self.params, self.prec
        g = pose
        for i in (1, 2):
            g = torch.relu(prec.linear(g, p[f'pose_extractor.mlp{i}.weight'],
                                       p[f'pose_extractor.mlp{i}.bias']))
        B, P, C = g.shape
        pair = torch.cat([g[:, None].expand(B, P, P, C),
                          g[:, :, None].expand(B, P, P, C)], -1)
        for i in (1, 2):
            pair = torch.relu(prec.linear(
                pair, p[f'relation_dense.mlp{i}.weight'],
                p[f'relation_dense.mlp{i}.bias']))
        rel = torch.sigmoid(prec.linear(pair, p['relation_dense.mlp3.weight'],
                                        p['relation_dense.mlp3.bias']))
        return rel[..., 0] * pair_valid

    def _hidden(self, B, F, generator, device):
        """[2, B, 2F]: one shared first half, each direction's own second
        half, drawn as the program draws them."""
        shared = torch.randn((1, 1, B, F), generator=generator,
                             device=device)
        own = torch.randn((1, 2, B, F), generator=generator, device=device)
        return torch.cat([shared.expand(1, 2, B, F), own], -1)[0]

    def sample(self, feats, generator):
        p, prec = self.params, self.prec
        x, valids, labels = feats['feats'], feats['valids'], feats['labels']
        B, P, F = x.shape
        counts = (valids > 0).sum(1)
        pair_valid = valids[:, :, None] * valids[:, None, :]
        pose = x.new_tensor([1.0, 0, 0, 0, 0, 0, 0]).expand(B, P, POSE_DIM)
        quats, trans = [], []
        for it in range(self.rounds):
            rel = self._relation(pose, pair_valid) if it else pair_valid
            pair = torch.cat([x[:, :, None].expand(B, P, P, F),
                              x[:, None].expand(B, P, P, F)], -1)
            edge = mlp(p, f'edge_mlps.{it}', pair, prec, True)
            msg = (edge * rel[..., None]).sum(2) / \
                (rel.sum(-1, keepdim=True) + 1e-6)
            h0 = self._hidden(B, F, generator, x.device)
            seq = torch.cat([x, msg], -1)
            out = torch.cat([
                gru_direction(p, f'grus.{it}.l0_d{d}', seq, counts, h0[d],
                              reverse=d == 1) for d in (0, 1)], -1)
            x = mlp(p, f'node_mlps.{it}', out, prec, False)
            q, t = pose_head(p, torch.cat([x, labels, pose], -1), prec,
                             prefix=f'pose_predictors.{it}')
            pose = torch.cat([q, t], -1)
            quats.append(q)
            trans.append(t)
        return torch.stack(quats), torch.stack(trans)
