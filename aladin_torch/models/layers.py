"""Head-side building blocks (mirrors aladin_tpu/models/layers.py): the
torch-semantics transformer encoder, depth aggregation, feature fusion,
pooling aggregators and positional encodings.

The matching head and the TERAN / post-OSCAR / depth stacks are
torch.nn.TransformerEncoder semantics written out: post-LN layers x =
LN1(x + drop(SelfAttn(x))); x = LN2(x + drop(W2 drop(relu(W1 x)))),
LayerNorm eps 1e-5, packed QKV projection, key-padding mask as -inf. The
parameter names are nn.TransformerEncoder's (``layers.N.self_attn.in_proj_weight``,
``linear1``, ``norm1``, ...), so the reference's stacks load with
``load_state_dict``. The math is spelled out instead of calling
nn.TransformerEncoder so that no fused fast path or nested-tensor
conversion changes it.

The depth aggregator's ``self_attn`` / ``gate_ffn`` and the feature
fusion's ``alphas.0`` / ``alphas.3`` are the names a released ALADIN
``.pth.tar`` holds. Reductions that aladin_tpu asks in f32
(``preferred_element_type``) run in f32 here too, autocast or not.

Under tensor parallelism (``parallel/sharding.py``) the attention holds its
heads' rows of each of the packed q, k and v blocks and the matching
columns of ``out_proj`` (row-parallel), and the TE layer its rows of
``linear1`` and columns of ``linear2``; the dropouts on those sharded
activations keep their slice of the whole tensor's mask.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aladin_torch.parallel.sharding import copy_to_tp, row_parallel_linear, sharded_dropout


class TorchMultiheadAttention(nn.Module):
    """nn.MultiheadAttention (self-attention, batch-first) semantics."""

    tp_mesh = None  # the mesh once parallel/sharding.py shards the module over tp

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
        tp = self.tp_mesh
        if tp is not None:
            x = copy_to_tp(x, tp)
        q, k, v = (t.reshape(b, s, -1, d).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        with torch.autocast(x.device.type, enabled=False):  # f32 scores, as in JAX
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
        if key_padding_mask is not None:  # True = padding
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        if tp is None:
            probs = self.dropout(probs)
        else:
            probs = sharded_dropout(probs, self.dropout.p, self.training, tp, dim=1)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, -1)
        return self.out_proj(ctx) if tp is None else row_parallel_linear(ctx, self.out_proj, tp)


class TorchTransformerEncoderLayer(nn.Module):
    tp_mesh = None

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
        tp = self.tp_mesh
        if tp is None:
            ff = self.linear2(self.dropout(torch.relu(self.linear1(x))))
        else:
            h = torch.relu(self.linear1(copy_to_tp(x, tp)))
            h = sharded_dropout(h, self.dropout.p, self.training, tp, dim=-1)
            ff = row_parallel_linear(h, self.linear2, tp)
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


class DepthAggregator(nn.Module):
    """Aggregate the (depth, B, S, D) hidden-state stack over depth. Modes:
    None / False -> the last entry; 'mean'; 'gated' -> per-(token, depth)
    sigmoid gates from a self-attention pass over each depth's tokens;
    'transformer' -> aladin_tpu's completion of the reference's latent
    defect (a mode it builds but never handles): a 1-layer TE over the
    depth axis of each token, its last position the aggregate."""

    def __init__(self, aggr, input_dim: int):
        super().__init__()
        if aggr not in (None, False, "mean", "gated", "transformer"):
            raise ValueError(f"unknown depth aggregation {aggr!r}")
        self.aggr = aggr
        if aggr == "gated":
            self.self_attn = TorchMultiheadAttention(input_dim, 4, 0.1)
            self.gate_ffn = nn.Linear(input_dim, 1)
        elif aggr == "transformer":
            self.depth_transformer = TorchTransformerEncoder(1, input_dim, nhead=4,
                                                             dim_feedforward=input_dim)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        if not self.aggr:
            return x[-1]
        if self.aggr == "mean":
            return x.mean(dim=0)
        depth, b, s, dim = x.shape
        if self.aggr == "gated":
            flat = x.reshape(depth * b, s, dim)
            mask = padding_mask[None].expand(depth, b, s).reshape(depth * b, s)
            gate = torch.sigmoid(self.gate_ffn(self.self_attn(flat, mask))).reshape(depth, b, s, 1)
            return (gate.float() * x.float()).sum(dim=0).to(x.dtype)
        seq = x.permute(1, 2, 0, 3).reshape(b * s, depth, dim)
        return self.depth_transformer(seq, None)[:, -1, :].reshape(b, s, dim)


class FeatureFusion(nn.Module):
    """Learned 2-way weighted fusion: a * alpha_0 + b * alpha_1, the alphas
    a sigmoid MLP of [a ; b]."""

    def __init__(self, feat_dim: int):
        super().__init__()
        self.alphas = nn.Sequential(nn.Linear(2 * feat_dim, 512), nn.ReLU(), nn.Dropout(0.1),
                                    nn.Linear(512, 2), nn.Sigmoid())

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        alphas = self.alphas(torch.cat([a, b], dim=-1))
        return a * alphas[..., 0:1] + b * alphas[..., 1:2]


class GatedAggregation(nn.Module):
    """Sigmoid-gated sum pooling over tokens; padded tokens' gate logits
    are -inf, so they contribute nothing."""

    def __init__(self, feat_dim: int):
        super().__init__()
        self.gate_fn = nn.Sequential(nn.Linear(feat_dim, feat_dim), nn.ReLU(),
                                     nn.Linear(feat_dim, 1))
        self.node_fn = nn.Sequential(nn.Linear(feat_dim, feat_dim), nn.ReLU(),
                                     nn.Linear(feat_dim, feat_dim))

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        m = torch.sigmoid(self.gate_fn(x).masked_fill(padding_mask[..., None], float("-inf")))
        return (m.float() * self.node_fn(x).float()).sum(dim=1).to(x.dtype)


class Aggregator(nn.Module):
    """Sequence -> vector pooling. Modes: 'first' (token 0), 'sum',
    'sum-and-map' (the sum through an MLP), 'gated' (GatedAggregation),
    'gru' (a GRU over each row's first ``lengths`` tokens, its final state)."""

    def __init__(self, embed_size: int, aggregation: str = "first"):
        super().__init__()
        if aggregation not in ("first", "sum", "sum-and-map", "gated", "gru"):
            raise ValueError(f"unsupported aggregation {aggregation!r}")
        self.aggregation = aggregation
        if aggregation == "sum-and-map":
            self.map = nn.Sequential(nn.Linear(embed_size, embed_size), nn.ReLU(),
                                     nn.Linear(embed_size, embed_size))
        elif aggregation == "gated":
            self.gated_aggr = GatedAggregation(embed_size)
        elif aggregation == "gru":
            self.gru_aggr = nn.GRU(embed_size, embed_size, batch_first=True)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                padding_mask: torch.Tensor) -> torch.Tensor:
        if self.aggregation == "first":
            return x[:, 0, :]
        if self.aggregation in ("sum", "sum-and-map"):
            out = x.masked_fill(padding_mask[..., None], 0.0).sum(dim=1)
            return self.map(out) if self.aggregation == "sum-and-map" else out
        if self.aggregation == "gated":
            return self.gated_aggr(x, padding_mask)
        packed = nn.utils.rnn.pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                                   enforce_sorted=False)
        return self.gru_aggr(packed)[1][-1]


def sinusoidal_positions(max_len: int, d_model: int) -> torch.Tensor:
    """(max_len, d_model) sin / cos table: sin at even columns, cos at odd."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


class PositionalEncodingText(nn.Module):
    """Additive sinusoidal positions, then dropout."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 5000):
        super().__init__()
        self.register_buffer("pe", sinusoidal_positions(max_len, d_model), persistent=False)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + self.pe[None, :x.shape[1]].to(x.dtype))


class PositionalEncodingImageGrid(nn.Module):
    """Each cell of an n x n region grid gets its (x, y) in [-1, 1] through a
    learned Linear, added; an optional leading start token gets an off-grid
    coordinate."""

    def __init__(self, d_model: int, n_regions: int = 4):
        super().__init__()
        self.n_regions = n_regions
        self.map = nn.Linear(2, d_model)

    def forward(self, x: torch.Tensor, start_token: bool = False) -> torch.Tensor:
        n = self.n_regions
        coords = torch.linspace(-1.0, 1.0, n, device=x.device)
        grid = torch.stack([coords[None, :].expand(n, n), coords[:, None].expand(n, n)],
                           dim=2).reshape(n * n, 2)
        pe = self.map(grid)
        if start_token:
            pe0 = self.map(torch.tensor([[-1.0 - 2.0 / n, -1.0]], device=x.device))
            return torch.cat([x[:, :1] + pe0[None], x[:, 1:] + pe[None, :x.shape[1] - 1]], dim=1)
        return x + pe[None, :x.shape[1]]


class PositionalEncodingImageBoxes(nn.Module):
    """Box geometry [x1, y1, x2, y2, area] as a positional signal:
    'project-and-sum' adds Linear(geometry) to the features;
    'concat-and-process' runs an MLP over [features ; geometry]."""

    def __init__(self, d_model: int, mode: str = "project-and-sum"):
        super().__init__()
        self.mode = mode
        if mode == "project-and-sum":
            self.map = nn.Linear(5, d_model)
        elif mode == "concat-and-process":
            self.map = nn.Sequential(nn.Linear(d_model + 5, d_model), nn.ReLU(),
                                     nn.Linear(d_model, d_model))
        else:
            raise ValueError(mode)

    def forward(self, x: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
        s = torch.cat([boxes, area[..., None]], dim=-1)
        if self.mode == "project-and-sum":
            return x + self.map(s)
        return self.map(torch.cat([x, s], dim=-1))
