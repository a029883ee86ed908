"""Masked (bi)directional GRU with fused gate projections.

Port of multi_part_assembly_tpu/models/modules/rnn.py:24-133.  Valid
entries are a prefix of the part axis, so a masked carry replaces packing:
a padded step keeps the previous hidden state and emits zeros, and the
reverse direction runs over the flipped sequence and mask, where the carry
skips the leading padding.

`FusedGRUCell` packs the three input projections into one [C, 3H] matmul,
run once over the whole [B, T, C] sequence outside the step loop, and the
three hidden projections into one [H, 3H] matmul a step.  The gate order is
r|z|n, as torch's weight_ih / weight_hh rows.  The JAX package has no Pallas
kernel here: this step loop is what it computes.  All in f32, as the JAX
cells' Dense layers.  Each call adds its recurrent steps (layers x
directions x T) to the counter `gru.steps` (utils/tracing.py).
"""

import torch
from torch import nn

from ...utils import tracing

__all__ = ['FusedGRUCell', 'MaskedGRU']


class FusedGRUCell(nn.Module):
    """GRU cell (JAX rnn.py:24-71):
        r = sigmoid(x W_ir + b_ir' + h W_hr)
        z = sigmoid(x W_iz + b_iz' + h W_hz)
        n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
        h' = (1 - z) n + z h
    with torch's r/z biases b_ih + b_hh merged into `wi.bias` and the n
    gate's hidden bias kept apart as `bhn`, since r multiplies it."""

    def __init__(self, input_size, hidden_size):
        super().__init__()
        self.wi = nn.Linear(input_size, 3 * hidden_size)
        self.wh = nn.Linear(hidden_size, 3 * hidden_size, bias=False)
        self.bhn = nn.Parameter(torch.zeros(hidden_size))
        nn.init.orthogonal_(self.wh.weight)

    def project(self, x):
        """The input half, for one step or a whole [B, T, C] sequence."""
        return self.wi(x)

    def apply_proj(self, h, xp):
        """One recurrent step from a precomputed input projection."""
        xr, xz, xn = xp.chunk(3, dim=-1)
        hr, hz, hn = self.wh(h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + self.bhn))
        return (1.0 - z) * n + z * h

    def forward(self, h, x):
        return self.apply_proj(h, self.project(x))


class MaskedGRU(nn.Module):
    """Multi-layer, optionally bidirectional GRU with validity masking
    (JAX rnn.py:85-133).  Input [B, T, C]; hidden [num_layers, num_dirs,
    B, H].  Returns ([B, T, H * num_dirs], last hidden).  Dropout between
    layers in train mode only."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False, dropout=0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_dirs = 2 if bidirectional else 1
        self.drop = nn.Dropout(dropout)
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else \
                hidden_size * self.num_dirs
            for d in range(self.num_dirs):
                setattr(self, f'l{layer}_d{d}',
                        FusedGRUCell(in_size, hidden_size))

    def forward(self, x, init_hidden=None, valids=None):
        B, T, _ = x.shape
        tracing.count('gru.steps', self.num_layers * self.num_dirs * T)
        mask = x.new_ones((B, T)) if valids is None else valids.to(x.dtype)
        if init_hidden is None:
            init_hidden = x.new_zeros((self.num_layers, self.num_dirs, B,
                                       self.hidden_size))
        last_hidden = []
        h_seq = x
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.num_dirs):
                inp = h_seq if d == 0 else h_seq.flip(1)
                m = (mask if d == 0 else mask.flip(1))[..., None]
                cell = getattr(self, f'l{layer}_d{d}')
                xp = cell.project(inp)  # [B, T, 3H] in one matmul
                h = init_hidden[layer, d]
                steps = []
                for t in range(T):
                    new_h = cell.apply_proj(h, xp[:, t])
                    m_t = m[:, t]
                    h = m_t * new_h + (1.0 - m_t) * h
                    steps.append(m_t * new_h)
                out = torch.stack(steps, dim=1)
                outs.append(out if d == 0 else out.flip(1))
                last_hidden.append(h)
            h_seq = torch.cat(outs, dim=-1) if self.num_dirs > 1 else outs[0]
            if layer < self.num_layers - 1:
                h_seq = self.drop(h_seq)
        last_hidden = torch.stack(last_hidden, dim=0).reshape(
            self.num_layers, self.num_dirs, B, self.hidden_size)
        return h_seq, last_hidden
