"""B-LSTM: Bi-GRU seq2seq assembly model (port of
multi_part_assembly_tpu/models/lstm.py:23-145).

The decoder is a step loop over the part axis.  Its teacher-forcing flag is
one Bernoulli draw for the whole forward, kept on the device and applied
with `torch.where`, so a step costs no host sync.  The hidden noise and the
flag come from the caller's generator; `hidden_noise_override` and
`teacher_force_override` fix them (tests, and the card-against-CPU check of
chip_smoke.py, whose two sides must draw alike).
"""

import torch
import torch.nn.functional as F
from torch import nn

from .base import extract_part_feats
from .modules.encoders import build_encoder
from .modules.regressor import StochasticPoseRegressor
from .modules.rnn import FusedGRUCell, MaskedGRU

__all__ = ['LSTMModel', 'Seq2Seq']


class _DecoderStep(nn.Module):
    """One autoregressive decoder step: 2-layer GRU + output head
    (JAX lstm.py:23-64)."""

    def __init__(self, input_size, hidden_size):
        super().__init__()
        self.cell0 = FusedGRUCell(input_size, hidden_size)
        self.cell1 = FusedGRUCell(hidden_size, hidden_size)
        # Linear -> LeakyReLU(True) -> Linear in the reference, and
        # LeakyReLU's first argument is the slope: True is 1.0, the
        # identity, so no activation here (JAX lstm.py:47-55)
        self.lin1a = nn.Linear(hidden_size, 256)
        self.lin1b = nn.Linear(256, input_size)
        self.lin3a = nn.Linear(hidden_size, 128)
        self.lin3b = nn.Linear(128, 1)
        self.drop_i = nn.Dropout(0.2)
        self.drop_mid = nn.Dropout(0.2)  # torch's inter-layer dropout
        self.drop_s = nn.Dropout(0.2)

    def forward(self, h1, h2, prev_out, target_t, teacher_force):
        inp = torch.where(teacher_force, target_t, prev_out.detach())
        # the reference's "locked" dropout sees a length-1 sequence a step,
        # so its masks are fresh every step (JAX lstm.py:33-45)
        nh1 = self.cell0(h1, self.drop_i(inp))
        nh2 = self.cell1(h2, self.drop_mid(nh1))
        # the output head reads the FIRST layer's hidden (JAX lstm.py:47)
        out_code = self.lin1b(self.lin1a(nh1))
        st = self.drop_s(F.relu(self.lin3a(nh1)))
        return nh1, nh2, out_code, self.lin3b(st)


class Seq2Seq(nn.Module):
    """2-layer Bi-GRU encoder + autoregressive GRU decoder with teacher
    forcing and `noise_dim`-d noise in the decoder's hidden state
    (JAX lstm.py:67-112)."""

    def __init__(self, feat_dim, hidden_size=256, noise_dim=16,
                 teacher_forcing_ratio=0.5):
        super().__init__()
        self.noise_dim = noise_dim
        self.teacher_forcing_ratio = teacher_forcing_ratio
        self.encoder = MaskedGRU(feat_dim, hidden_size, num_layers=2,
                                 bidirectional=True, dropout=0.2)
        self.decoder = _DecoderStep(feat_dim, 2 * hidden_size + noise_dim)

    def forward(self, input_seq, target_seq, valids=None, generator=None,
                hidden_noise=None, teacher_force=None):
        """input_seq / target_seq: [B, P, C].  Returns the outputs
        [B, P, C] and stop signs [B, P, 1].  `hidden_noise` [2, B,
        noise_dim] and `teacher_force` (a bool, train mode) replace the
        draws."""
        B, P, C = input_seq.shape
        dev = input_seq.device
        _, hidden = self.encoder(input_seq, None, valids)
        # [2 layers, 2 dirs, B, H] -> [2, B, 2H]
        enc_hidden = torch.cat([hidden[:, 0], hidden[:, 1]], dim=-1)
        if hidden_noise is None:
            hidden_noise = torch.randn((2, B, self.noise_dim),
                                       generator=generator, device=dev,
                                       dtype=input_seq.dtype)
        dec_hidden = torch.cat([enc_hidden, hidden_noise.to(enc_hidden)],
                               dim=-1)
        if not self.training:
            tf = torch.tensor(False, device=dev)
        elif teacher_force is not None:
            tf = torch.tensor(bool(teacher_force), device=dev)
        else:  # one draw for the whole forward (JAX lstm.py:93-95)
            tf = torch.rand((), generator=generator, device=dev) < \
                self.teacher_forcing_ratio
        h1, h2 = dec_hidden[0], dec_hidden[1]
        prev = input_seq.new_zeros((B, C))
        outputs, stops = [], []
        for t in range(P):
            h1, h2, prev, stop = self.decoder(h1, h2, prev, target_seq[:, t],
                                              tf)
            outputs.append(prev)
            stops.append(stop)
        return torch.stack(outputs, dim=1), torch.stack(stops, dim=1)


class LSTMModel(nn.Module):
    """PointNet part features -> Seq2Seq -> stochastic pose head (JAX
    lstm.py:115-145)."""

    def __init__(self, rot_type='quat', pc_feat_dim=128,
                 encoder_arch='pointnet', noise_dim=32, lstm_hidden_size=256,
                 label_dim=0, compute_dtype=torch.float32,
                 hidden_noise_override=None, teacher_force_override=None):
        super().__init__()
        self.enc = build_encoder(encoder_arch, pc_feat_dim,
                                 compute_dtype=compute_dtype)
        self.seq2seq = Seq2Seq(pc_feat_dim, hidden_size=lstm_hidden_size)
        self.head = StochasticPoseRegressor(
            pc_feat_dim + label_dim, noise_dim, rot_type=rot_type,
            compute_dtype=compute_dtype)
        self.hidden_noise_override = hidden_noise_override
        self.teacher_force_override = teacher_force_override

    def precompute(self, data_dict):
        return {'part_feats': extract_part_feats(
            self.enc, data_dict['part_pcs'], data_dict['part_valids'])}

    def sample(self, feats, data_dict, generator=None):
        part_feats = feats['part_feats']
        output_seq, _ = self.seq2seq(
            part_feats, part_feats.detach(), valids=data_dict['part_valids'],
            generator=generator, hidden_noise=self.hidden_noise_override,
            teacher_force=self.teacher_force_override)
        f = torch.cat([output_seq, data_dict['part_label'],
                       data_dict['instance_label']], dim=-1)
        rot, trans = self.head(f, generator)
        return {'rot': rot, 'trans': trans}

    def forward(self, data_dict, generator=None):
        return self.sample(self.precompute(data_dict), data_dict, generator)
