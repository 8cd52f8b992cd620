"""The matching head: torch.nn.TransformerEncoder semantics written out
(mirrors aladin_tpu/models/layers.py::TorchTransformerEncoder).

Post-LN layers: x = LN1(x + drop(SelfAttn(x))); x = LN2(x + drop(W2
drop(relu(W1 x)))), LayerNorm eps 1e-5, packed QKV projection, key-padding
mask as -inf. The parameter names are nn.TransformerEncoder's
(``layers.N.self_attn.in_proj_weight``, ``linear1``, ``norm1``, ...), so the
reference's stacks load with ``load_state_dict``. The math is spelled out
instead of calling nn.TransformerEncoder so that no fused fast path or
nested-tensor conversion changes it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class TorchMultiheadAttention(nn.Module):
    """nn.MultiheadAttention (self-attention, batch-first) semantics."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.dropout = nn.Dropout(dropout)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, e = x.shape
        d = e // self.num_heads
        q, k, v = (t.reshape(b, s, self.num_heads, d).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        with torch.autocast(x.device.type, enabled=False):  # f32 scores, as in JAX
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
        if key_padding_mask is not None:  # True = padding
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
        probs = self.dropout(torch.softmax(scores, dim=-1).to(v.dtype))
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, e)
        return self.out_proj(ctx)


class TorchTransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.self_attn = TorchMultiheadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, key_padding_mask):
        x = self.norm1(x + self.dropout(self.self_attn(x, key_padding_mask)))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(x))))
        return self.norm2(x + self.dropout(ff))


class TorchTransformerEncoder(nn.Module):
    """A stack of TorchTransformerEncoderLayer with no final norm."""

    def __init__(self, num_layers: int, d_model: int, nhead: int = 4,
                 dim_feedforward: Optional[int] = None, dropout: float = 0.1):
        super().__init__()
        ff = dim_feedforward or d_model
        self.layers = nn.ModuleList(
            TorchTransformerEncoderLayer(d_model, nhead, ff, dropout) for _ in range(num_layers))

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, key_padding_mask)
        return x
