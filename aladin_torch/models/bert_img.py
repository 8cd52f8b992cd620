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
    ``bias[:, 0]`` with one dropout seed per layer call, drawn on the card
    from the CUDA default generator (no card sync, and new on every replay
    of a CUDA graph), or on the CPU from the model's ``seed_generator``; it
    returns no probs, so ``output_attentions`` raises;
  * ``fused_layernorm``: kernel K3a (ops/kernels/layernorm.py) on
    ``(x, sublayer_out)`` cast to the sublayer's dtype.

``remat`` (training only: the module in train mode with grad enabled) runs
each encoder layer under a non-reentrant ``torch.utils.checkpoint``: only
the layer's inputs stay for the backward, which runs the layer again. The
K2 seeds are drawn before the layers and enter each as an input, so the
rerun regenerates the same masks; checkpoint restores the generators for
the plain dropouts. Under remat K2 and K3a launch their forwards twice a
layer call.

and the int8 serving encoder (``quant_matmuls``, evaluation only):

  * the Q/K/V projections run as one W8A8 GEMM over their concatenated
    weights and the FFN-up projection as another with the activation in its
    epilogue (models/quant.py: K4-dynx, quantizing the activations inside
    the GEMM); the attention-output and FFN-down projections stay float;
  * with ``fused_layernorm`` as well, both residual LayerNorms of every
    layer are K3b, which also emits the int8 rows of its output: the
    attention LN's feed FFN-up and the output LN's the next layer's QKV,
    through K4; layer 0's QKV takes ``layernorm_q8`` of the embeddings.

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
from torch.utils.checkpoint import checkpoint

from aladin_torch.models.quant import FusedQuantLinear, QuantLinear
from aladin_torch.ops.kernels.attention_kernel import fused_attention
from aladin_torch.ops.kernels.layernorm import (layernorm_q8, residual_layernorm,
                                                residual_layernorm_q8)
from aladin_torch.ops.masking import additive_attention_bias


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


def init_weights(module: nn.Module, generator: torch.Generator, std: float) -> None:
    """Random weights from ``generator`` in ``named_parameters`` order:
    normal(0, std) matrices and embeddings, zero biases, unit LayerNorm
    scales."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=generator) * std)
            elif ("LayerNorm" in name or "norm" in name) and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()


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

    def forward(self, input_ids, token_type_ids, position_ids=None):
        pos = (torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
               if position_ids is None else position_ids)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + select_rows(self.token_type_embeddings.weight, token_type_ids))
        return self.dropout(self.LayerNorm(x))


def select_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a table of a few rows (the token types), as a
    chain of ``torch.where`` selects: the forward copies the rows exactly as
    the embedding lookup does, and each row's gradient is a reduction over
    the positions in a fixed order. The lookup's CUDA backward sums every
    position into its row with atomics once there are more than 3072
    indices, so a step at B 128 would not repeat itself bit for bit. Ids
    past the table select row 0."""
    out = table[0].expand(*ids.shape, table.shape[1])
    for t in range(1, table.shape[0]):
        out = torch.where((ids == t)[..., None], table[t], out)
    return out


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.fused_qkv = cfg.fused_qkv
        self.fused_attention = cfg.fused_attention
        self.dropout_rate = cfg.attention_probs_dropout_prob
        linear = QuantLinear if cfg.quant_matmuls else nn.Linear
        self.query = linear(cfg.hidden_size, cfg.hidden_size)
        self.key = linear(cfg.hidden_size, cfg.hidden_size)
        self.value = linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.attention_probs_dropout_prob)
        self.qkv = (FusedQuantLinear([self.query, self.key, self.value]) if cfg.quant_matmuls
                    else None)

    def project(self, x, x_q8=None):
        """(q, k, v), each (B, S, H, d), of the rows ``x``."""
        b, s, _ = x.shape
        if self.qkv is not None:  # one W8A8 GEMM; x_q8: x quantized upstream
            qkv = self.qkv(x) if x_q8 is None else self.qkv.forward_xq(*x_q8, x.dtype)
            q, k, v = qkv.chunk(3, dim=-1)
        elif self.fused_qkv:  # one GEMM over the concatenated weights: same math
            w = torch.cat([self.query.weight, self.key.weight, self.value.weight], dim=0)
            bb = torch.cat([self.query.bias, self.key.bias, self.value.bias])
            q, k, v = F.linear(x, w, bb).chunk(3, dim=-1)
        else:
            q, k, v = self.query(x), self.key(x), self.value(x)
        return tuple(t.reshape(b, s, self.num_heads, self.head_dim) for t in (q, k, v))

    def attend(self, q, k, v, bias):
        """The plain attention core: (ctx (B, Q, H * d), probs (B, H, Q, K))
        of queries (B, Q, H, d) over keys and values (B, K, H, d) under an
        additive bias broadcastable to (B, H, Q, K); scores and softmax in
        f32, the rest in v's dtype."""
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        with torch.autocast(q.device.type, enabled=False):  # f32 scores, as in JAX
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(self.head_dim) + bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.matmul(self.dropout(probs), v)
        return ctx.transpose(1, 2).reshape(q.shape[0], q.shape[2], -1), probs

    def forward(self, x, bias, seed=None, x_q8=None):
        b, s, _ = x.shape
        q, k, v = self.project(x, x_q8)
        if self.fused_attention:  # (B, S, H, d) as projected: no transposes
            ctx = fused_attention(q, k, v, bias[:, 0], seed, self.dropout_rate,
                                  self.training and seed is not None)
            return ctx.reshape(b, s, -1), None
        return self.attend(q, k, v, bias)


class BertSelfOutput(nn.Module):
    """dense -> dropout -> LN(x + res); also the FFN output (``BertOutput``)."""

    def __init__(self, cfg: BertImgConfig, in_features: Optional[int] = None):
        super().__init__()
        self.dense = nn.Linear(in_features or cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.fused_layernorm = cfg.fused_layernorm
        self.emit_q8 = cfg.fused_layernorm and cfg.quant_matmuls

    def forward(self, h, res):
        """(LN(res + dropout(dense(h))), its (q, s) from K3b with ``emit_q8``
        or None)."""
        h = self.dropout(self.dense(h))
        ln = self.LayerNorm
        if self.emit_q8:
            y, q, s = residual_layernorm_q8(res.to(h.dtype), h, ln.weight, ln.bias, ln.eps)
            return y, (q, s)
        if self.fused_layernorm:  # K3a on (x, sublayer out) in the sublayer's dtype
            return residual_layernorm(res.to(h.dtype), h, ln.weight, ln.bias, ln.eps), None
        return self.LayerNorm(res + h), None


class BertAttention(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, x, bias, seed=None, x_q8=None):
        ctx, probs = self.self(x, bias, seed, x_q8)
        return (*self.output(ctx, x), probs)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.quant = cfg.quant_matmuls
        if self.quant:  # the activation rides the W8A8 GEMM's epilogue
            self.dense = QuantLinear(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act)
        else:
            self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x, x_q8=None):
        if not self.quant:
            return ffn_act(self.dense(x), self.act)
        return self.dense(x) if x_q8 is None else self.dense.forward_xq(*x_q8, x.dtype)


class BertLayer(nn.Module):
    """One post-LN BERT encoder layer. ``x_q8`` (the int8 serving encoder
    with ``fused_layernorm``) is x quantized by the previous layer's output
    LayerNorm (or the layer-0 seed); the layer returns its own output's."""

    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertSelfOutput(cfg, cfg.intermediate_size)

    def forward(self, x, bias, seed=None, x_q8=None):
        """(output, attention probs or None, the output's (q, s) or None)."""
        x, ln1_q8, probs = self.attention(x, bias, seed, x_q8)
        out, ln2_q8 = self.output(self.intermediate(x, ln1_q8), x)
        return out, probs, ln2_q8


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
        self.cfg = cfg
        # per-call dropout seeds of the fused attention on the CPU; on the
        # card they are drawn on the card (see forward)
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
            if x.device.type == "cuda":
                # the CUDA default generator: Philox offsets that a CUDA graph
                # advances on every replay, read by the kernel on the card
                seeds = list(torch.randint(0, 2 ** 31 - 1, (len(layers),), device=x.device))
            else:
                seeds = torch.randint(0, 2 ** 31 - 1, (len(layers),),
                                      generator=self.seed_generator).tolist()

        # the int8 stream of the quantized encoder with fused LayerNorms
        x_q8 = layernorm_q8(x) if self.cfg.quant_matmuls and self.cfg.fused_layernorm else None
        # remat: each layer keeps only its inputs and runs again in the
        # backward; the seeds were drawn above, so the rerun reads the same
        # ones, and checkpoint restores the generators for the plain dropouts
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        hidden, attentions = [x], []
        for layer, seed in zip(layers, seeds):
            if remat:
                x, probs, x_q8 = checkpoint(layer, x, bias, seed, x_q8, use_reentrant=False)
            else:
                x, probs, x_q8 = layer(x, bias, seed, x_q8)
            if output_hidden_states:
                hidden.append(x)
            if output_attentions:
                attentions.append(probs)
        pooled = self.pooler(x)
        all_hidden = torch.stack(hidden) if output_hidden_states else None
        all_attn = torch.stack(attentions) if output_attentions else None
        return x, pooled, all_hidden, all_attn


class ImageBertClassifier(nn.Module):
    """OSCAR pair classifier head (mirrors aladin_tpu's): the pooled CLS ->
    dropout -> Linear(num_labels), named ``classifier`` as in OSCAR's
    checkpoints (ref:oscar/modeling/modeling_bert.py:290-354)."""

    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.bert = BertImgModel(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(self, input_ids, attention_mask, token_type_ids=None, img_feats=None,
                output_attentions: bool = False):
        """(logits, sequence output, hidden states or None, attentions or None)."""
        seq, pooled, hidden, attn = self.bert(input_ids, attention_mask, token_type_ids,
                                              img_feats, output_attentions)
        return self.classifier(self.dropout(pooled)), seq, hidden, attn
