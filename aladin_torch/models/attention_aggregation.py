"""Attention-score aggregation modules (mirrors
aladin_tpu/models/attention_aggregation.py).

Attention pooling that collapses each modality's token set to one vector:
a learned query scored against every token, optionally multi-headed, and
the self-aggregation wrapper pairing the two modalities. Dead code in the
reference (imported nowhere), ported as part of its inventory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class ScoreDotProductAttention(nn.Module):
    """softmax(x · query / temperature) over the tokens, then the weighted
    sum of the tokens: (B, S, D) -> (B, D). ``temperature`` defaults to
    sqrt(d_model); padded tokens get -inf scores."""

    def __init__(self, d_model: int, temperature: Optional[float] = None):
        super().__init__()
        self.temperature = temperature or d_model ** 0.5
        self.query = nn.Parameter(torch.randn(d_model) * 0.02)

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        scores = torch.einsum("bsd,d->bs", x, self.query.to(x.dtype)) / self.temperature
        if padding_mask is not None:
            scores = scores.masked_fill(padding_mask, float("-inf"))
        return torch.einsum("bs,bsd->bd", torch.softmax(scores, dim=-1), x)


class MultiHeadAttentionAggregation(nn.Module):
    """``n_head`` pooled views, concatenated, projected back to d_model and
    layer-normalised (eps 1e-6)."""

    def __init__(self, d_model: int, n_head: int = 4):
        super().__init__()
        self.heads = nn.ModuleList(ScoreDotProductAttention(d_model) for _ in range(n_head))
        self.out_proj = nn.Linear(n_head * d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cat = torch.cat([head(x, padding_mask) for head in self.heads], dim=-1)
        return self.norm(self.out_proj(cat))


class SelfAggregation(nn.Module):
    """Both modalities' token sets to single vectors, one aggregator each."""

    def __init__(self, d_model: int, n_head: int = 4):
        super().__init__()
        self.img_aggregation = MultiHeadAttentionAggregation(d_model, n_head)
        self.cap_aggregation = MultiHeadAttentionAggregation(d_model, n_head)

    def forward(self, img_set: torch.Tensor, cap_seq: torch.Tensor,
                img_pad: Optional[torch.Tensor] = None,
                cap_pad: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.img_aggregation(img_set, img_pad), self.cap_aggregation(cap_seq, cap_pad)
