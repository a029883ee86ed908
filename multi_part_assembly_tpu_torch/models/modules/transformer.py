"""Transformer encoder with key-padding masks.

Port of multi_part_assembly_tpu/models/modules/transformer.py:19-98
(torch TransformerEncoderLayer semantics).  Attention runs over P <= 20
part tokens, plain matmul and softmax as in the JAX package (no Pallas
kernel there): projections in `compute_dtype`, softmax and LayerNorm in f32.
Parameter names follow torch's nn.TransformerEncoder
(`transformer_encoder.layers.{i}.self_attn.in_proj_weight`, ...), so the
torch reference's weights load by name.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ['TransformerEncoder']


def _linear(x, layer, dtype):
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class _SelfAttention(nn.Module):
    """Multi-head self-attention with torch's packed q/k/v parameters and
    flax's arithmetic (query scaled by 1/sqrt(head_dim) before the logits;
    masked logits set to the f32 minimum; f32 softmax)."""

    def __init__(self, d_model, num_heads, dropout):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.dropout = nn.Dropout(dropout)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x, key_valid, dtype):
        """x: [B, T, C]; key_valid: [B, T] bool or None."""
        B, T, C = x.shape
        H = self.num_heads
        qkv = F.linear(x.to(dtype), self.in_proj_weight.to(dtype),
                       self.in_proj_bias.to(dtype))
        q, k, v = qkv.reshape(B, T, 3, H, C // H).unbind(2)  # [B, T, H, hd]
        q = q / math.sqrt(C // H)
        logits = torch.einsum('bqhd,bkhd->bhqk', q, k).float()
        if key_valid is not None:
            logits = logits.masked_fill(~key_valid[:, None, None, :],
                                        torch.finfo(torch.float32).min)
        attn = self.dropout(logits.softmax(-1).to(dtype))
        out = torch.einsum('bhqk,bkhd->bqhd', attn, v).reshape(B, T, C)
        return _linear(out, self.out_proj, dtype)


class _EncoderLayer(nn.Module):
    """One pre- or post-LN encoder layer, dropout at torch's four places."""

    def __init__(self, d_model, num_heads, ffn_dim, norm_first, dropout,
                 compute_dtype):
        super().__init__()
        self.norm_first = norm_first
        self.compute_dtype = compute_dtype
        self.self_attn = _SelfAttention(d_model, num_heads, dropout)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        # torch LayerNorm's eps (JAX transformer.py:58-62)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)

    def _sa(self, h, key_valid):
        return self.dropout1(
            self.self_attn(h, key_valid, self.compute_dtype))

    def _ffn(self, h):
        cdt = self.compute_dtype
        h = self.dropout(F.relu(_linear(h, self.linear1, cdt)))
        return self.dropout2(_linear(h, self.linear2, cdt))

    def forward(self, x, key_valid):
        if self.norm_first:
            x = x + self._sa(self.norm1(x), key_valid)
            x = x + self._ffn(self.norm2(x))
        else:
            x = self.norm1(x + self._sa(x, key_valid))
            x = self.norm2(x + self._ffn(x))
        return x.float()


class _EncoderStack(nn.Module):
    def __init__(self, layers, norm):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class TransformerEncoder(nn.Module):
    """Stacked encoder layers with a final LN in pre-LN mode and, with
    `out_dim`, a final f32 projection `out_fc` (JAX transformer.py:72-98)."""

    def __init__(self, d_model, num_heads, ffn_dim, num_layers,
                 norm_first=True, dropout=0.1, compute_dtype=torch.float32,
                 out_dim=None):
        super().__init__()
        layers = [_EncoderLayer(d_model, num_heads, ffn_dim, norm_first,
                                dropout, compute_dtype)
                  for _ in range(num_layers)]
        norm = nn.LayerNorm(d_model, eps=1e-5) if norm_first else None
        self.transformer_encoder = _EncoderStack(layers, norm)
        self.out_fc = None if out_dim is None else \
            nn.Linear(d_model, out_dim)

    def forward(self, tokens, valid_masks=None):
        """tokens: [B, T, C]; valid_masks: [B, T], True/1 = valid."""
        key_valid = None if valid_masks is None else valid_masks > 0
        x = tokens
        for layer in self.transformer_encoder.layers:
            x = layer(x, key_valid)
        if self.transformer_encoder.norm is not None:
            x = self.transformer_encoder.norm(x)
        if self.out_fc is not None:
            x = self.out_fc(x)
        return x
