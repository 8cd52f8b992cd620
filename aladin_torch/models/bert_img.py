"""The OSCAR/VinVL cross-modal BERT backbone as torch modules (mirrors
aladin_tpu/models/bert_img.py).

Behaviour:

  * text path: word + absolute-position + token-type embeddings ->
    LayerNorm(eps 1e-12) -> dropout;
  * image path: Linear(img_feature_dim -> hidden) on the region features,
    optional LayerNorm (img_layer_norm_eps), dropout; no position or type
    embeddings; concatenated after the text tokens;
  * additive attention bias (1 - mask) * -10000 over 1-D (B, K) or 2-D
    (B, Q, K) masks;
  * post-LN encoder layers: self-attention -> dense -> dropout -> LN(x + res);
    intermediate gelu (exact erf; ``gelu_tanh`` optional) -> dense ->
    dropout -> LN(x + res);
  * pooler tanh(Linear(token 0));
  * returns (sequence_output, pooled, hidden_states (13, B, S, D) or None,
    attentions (L, B, H, S, S) or None).

Attention is a plain matmul/softmax chain, as aladin_tpu leaves it to XLA:
scores and softmax in f32, the rest in v's dtype (the parameter dtype, or
the autocast dtype in training). Two knobs route to the port's kernels, as
in aladin_tpu:

  * ``fused_attention``: kernel K2 (ops/kernels/attention_kernel.py) on
    ``bias[:, 0]`` with one dropout seed per layer call, drawn from the
    model's CPU ``seed_generator`` (no card sync); it returns no probs, so
    ``output_attentions`` raises;
  * ``fused_layernorm``: kernel K3a (ops/kernels/layernorm.py) on
    ``(x, sublayer_out)`` cast to the sublayer's dtype.

Module names follow OSCAR's state-dict keys (``embeddings.LayerNorm``,
``encoder.layer.N.attention.self.query``,
``encoder.layer.N.attention.output.LayerNorm``, ``img_embedding``,
``LayerNorm`` for the image LN, ``pooler.dense``) whatever the knobs, so
``pytorch_model.bin`` loads with ``load_state_dict`` after removing the
``bert.`` prefix.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aladin_torch.ops.kernels.attention_kernel import fused_attention
from aladin_torch.ops.kernels.layernorm import residual_layernorm
from aladin_torch.ops.masking import additive_attention_bias

_UNPORTED_KERNELS = {
    "quant_matmuls": "K4 (ops/pallas/quant_matmul.py::w8a8_matmul)",
}


@dataclasses.dataclass(frozen=True)
class BertImgConfig:
    """The BertConfig fields the backbone consumes (VinVL-base defaults);
    the same fields and defaults as aladin_tpu's."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    img_feature_dim: int = 2054
    img_feature_type: str = "frcnn"
    use_img_layernorm: bool = True
    img_layer_norm_eps: float = 1e-12
    num_labels: int = 2
    remat: bool = False
    quant_matmuls: bool = False
    hidden_act: str = "gelu"
    fused_layernorm: bool = False
    fused_qkv: bool = False
    fused_attention: bool = False

    @classmethod
    def from_json_dict(cls, d: dict) -> "BertImgConfig":
        keep = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in keep}
        if "use_img_layernorm" in d:
            kwargs["use_img_layernorm"] = bool(d["use_img_layernorm"])
        if d.get("hidden_act") == "gelu_new":  # HF's name for the tanh form
            kwargs["hidden_act"] = "gelu_tanh"
        return cls(**kwargs)

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


def ffn_act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x)
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown hidden_act {name!r} (gelu | gelu_tanh)")


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.LayerNorm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.fused_qkv = cfg.fused_qkv
        self.fused_attention = cfg.fused_attention
        self.dropout_rate = cfg.attention_probs_dropout_prob
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, x, bias, seed: Optional[int] = None):
        b, s, _ = x.shape
        if self.fused_qkv:  # one GEMM over the concatenated weights: same math
            w = torch.cat([self.query.weight, self.key.weight, self.value.weight], dim=0)
            bb = torch.cat([self.query.bias, self.key.bias, self.value.bias])
            q, k, v = F.linear(x, w, bb).chunk(3, dim=-1)
        else:
            q, k, v = self.query(x), self.key(x), self.value(x)
        q, k, v = (t.reshape(b, s, self.num_heads, self.head_dim) for t in (q, k, v))
        if self.fused_attention:  # (B, S, H, d) as projected: no transposes
            ctx = fused_attention(q, k, v, bias[:, 0], seed, self.dropout_rate,
                                  self.training and seed is not None)
            return ctx.reshape(b, s, -1), None
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        with torch.autocast(x.device.type, enabled=False):  # f32 scores, as in JAX
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(self.head_dim) + bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.matmul(self.dropout(probs), v)
        return ctx.transpose(1, 2).reshape(b, s, -1), probs


class BertSelfOutput(nn.Module):
    """dense -> dropout -> LN(x + res); also the FFN output (``BertOutput``)."""

    def __init__(self, cfg: BertImgConfig, in_features: Optional[int] = None):
        super().__init__()
        self.dense = nn.Linear(in_features or cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.fused_layernorm = cfg.fused_layernorm

    def forward(self, h, res):
        h = self.dropout(self.dense(h))
        if self.fused_layernorm:  # K3a on (x, sublayer out) in the sublayer's dtype
            ln = self.LayerNorm
            return residual_layernorm(res.to(h.dtype), h, ln.weight, ln.bias, ln.eps)
        return self.LayerNorm(res + h)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, x, bias, seed=None):
        ctx, probs = self.self(x, bias, seed)
        return self.output(ctx, x), probs


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.act = cfg.hidden_act

    def forward(self, x):
        return ffn_act(self.dense(x), self.act)


class BertLayer(nn.Module):
    """One post-LN BERT encoder layer."""

    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertSelfOutput(cfg, cfg.intermediate_size)

    def forward(self, x, bias, seed=None):
        x, probs = self.attention(x, bias, seed)
        return self.output(self.intermediate(x), x), probs


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_hidden_layers))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class BertImgModel(nn.Module):
    """Backbone over concatenated text tokens + projected region features.

    ``img_feats=None`` runs the text-only pass (ALADIN's caption branch);
    (B, R, img_feature_dim) features run the image branch.
    """

    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        for knob, kernel in _UNPORTED_KERNELS.items():
            if getattr(cfg, knob):
                raise NotImplementedError(
                    f"BertImgConfig.{knob} needs TPU kernel {kernel}, which the port has not "
                    "ported yet (ROADMAP.md, queue 2)")
        if cfg.remat:
            raise NotImplementedError("BertImgConfig.remat (the B >= 512 memory lever) is not "
                                      "ported yet (ROADMAP.md, queue 1, item 4)")
        self.cfg = cfg
        # per-call dropout seeds of the fused attention kernel (a CPU draw)
        self.seed_generator = torch.Generator().manual_seed(0)
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = BertPooler(cfg)
        self.img_embedding = nn.Linear(cfg.img_feature_dim, cfg.hidden_size)
        if cfg.use_img_layernorm:
            self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.img_layer_norm_eps)
        self.img_dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                img_feats: Optional[torch.Tensor] = None, output_attentions: bool = False,
                output_hidden_states: bool = False):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        if img_feats is not None:
            img = self.img_embedding(img_feats.to(x.dtype))
            if self.cfg.use_img_layernorm:
                img = self.LayerNorm(img)
            x = torch.cat([x, self.img_dropout(img)], dim=1)  # text first
        if output_attentions and self.cfg.fused_attention:
            raise ValueError(
                "fused_attention never materializes the attention probs; "
                "disable BertImgConfig.fused_attention for "
                "output_attentions consumers (attention distillation, "
                "probe tooling)")
        bias = additive_attention_bias(attention_mask, dtype=torch.float32)
        layers = self.encoder.layer
        seeds = [None] * len(layers)
        if self.cfg.fused_attention and self.training and self.cfg.attention_probs_dropout_prob > 0:
            seeds = torch.randint(0, 2 ** 31 - 1, (len(layers),),
                                  generator=self.seed_generator).tolist()

        hidden, attentions = [x], []
        for layer, seed in zip(layers, seeds):
            x, probs = layer(x, bias, seed)
            if output_hidden_states:
                hidden.append(x)
            if output_attentions:
                attentions.append(probs)
        pooled = self.pooler(x)
        all_hidden = torch.stack(hidden) if output_hidden_states else None
        all_attn = torch.stack(attentions) if output_attentions else None
        return x, pooled, all_hidden, all_attn
