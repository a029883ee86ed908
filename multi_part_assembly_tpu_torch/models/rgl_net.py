"""RGL-Net: DGL with a bidirectional GRU over the part sequence in every
node update (port of multi_part_assembly_tpu/models/rgl_net.py:15-57)."""

import torch

from .dgl import DGLModel, NodeMLP
from .modules.rnn import MaskedGRU

__all__ = ['RGLNet']


class RGLNet(DGLModel):
    """`hidden_noise_override`, [gnn_iter, 1, 2, B, 2F], fixes the GRUs'
    random initial hidden states (tests, and the card-against-CPU check of
    chip_smoke.py); None draws them from the caller's generator."""

    def __init__(self, *args, hidden_noise_override=None, **kwargs):
        super().__init__(*args, **kwargs)
        F_ = self.pc_feat_dim
        self.hidden_noise_override = hidden_noise_override
        self.grus = torch.nn.ModuleList([
            MaskedGRU(2 * F_, 2 * F_, num_layers=1, bidirectional=True)
            for _ in range(self.gnn_iter)])

    def _make_node_mlps(self, feat_dim):
        # input: the 4F GRU output; RGL's MLP4 has no final ReLU
        return torch.nn.ModuleList([
            NodeMLP(4 * feat_dim, feat_dim, final_relu=False,
                    compute_dtype=self.compute_dtype)
            for _ in range(self.gnn_iter)])

    def _init_gru_hidden(self, part_feats, iter_ind, generator):
        """Random initial hidden [1, 2, B, 2F]: both directions share one
        gaussian first half, and each draws its own second half (JAX
        rgl_net.py:36-47)."""
        if self.hidden_noise_override is not None:
            return self.hidden_noise_override[iter_ind].to(part_feats)
        B, _, F_ = part_feats.shape
        kw = dict(generator=generator, device=part_feats.device,
                  dtype=part_feats.dtype)
        shared = torch.randn((1, 1, B, F_), **kw).expand(1, 2, B, F_)
        other = torch.randn((1, 2, B, F_), **kw)
        return torch.cat([shared, other], dim=-1)

    def _node_update(self, part_feats, messages, valids, iter_ind,
                     generator):
        """GRU over [part_feats, messages], then the node MLP (JAX
        rgl_net.py:49-57)."""
        gru_in = torch.cat([part_feats, messages], dim=-1)  # [B, P, 2F]
        init_hidden = self._init_gru_hidden(part_feats, iter_ind, generator)
        gru_out, _ = self.grus[iter_ind](gru_in, init_hidden, valids=valids)
        return self.node_mlps[iter_ind](gru_out)  # from [B, P, 4F]
