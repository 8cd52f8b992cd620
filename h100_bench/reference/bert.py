"""Plain PyTorch VinVL-base BertImg backbone, written from the published
description (OSCAR / VinVL, ``oscar/modeling/modeling_bert.py``; BERT,
Devlin et al. 2019): no kernel, cache or program code.

  * text: word + absolute position + token-type embeddings -> LayerNorm
    (eps 1e-12);
  * image: Linear(img_feature_dim -> hidden) on the region features ->
    LayerNorm (eps 1e-12), concatenated after the text tokens;
  * attention bias (1 - mask) * -10000 over a (B, K) or (B, Q, K) mask;
  * post-LN layers: self-attention -> dense -> LN(x + .); gelu (erf) FFN
    -> dense -> LN(x + .);
  * dropout, where a ``Dropouts`` is given (``reference/dropout.py``): after
    the embeddings' and the regions' LayerNorms, on the attention
    probabilities and on each sublayer's output before its residual.

Weights are a dict under OSCAR's state-dict names (``embeddings.*``,
``encoder.layer.N.*``, ``img_embedding``, ``LayerNorm``) behind a prefix.
Every product, and each layer's LayerNorm outputs, go through a
``Precision`` (float32, or a control's).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference.dropout import Dropouts
from h100_bench.reference.precision import Precision

NEG = -10000.0


def spec(prefix: str, vocab: int, hidden: int, layers: int, intermediate: int,
         max_positions: int, type_vocab: int, img_feature_dim: int,
         pooler: bool = True) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every backbone weight, in the order the benchmark
    draws them."""
    h, i = hidden, intermediate
    out = [("embeddings.word_embeddings.weight", (vocab, h)),
           ("embeddings.position_embeddings.weight", (max_positions, h)),
           ("embeddings.token_type_embeddings.weight", (type_vocab, h)),
           ("embeddings.LayerNorm.weight", (h,)), ("embeddings.LayerNorm.bias", (h,))]
    for n in range(layers):
        p = f"encoder.layer.{n}."
        out += [(p + "attention.self.query.weight", (h, h)), (p + "attention.self.query.bias", (h,)),
                (p + "attention.self.key.weight", (h, h)), (p + "attention.self.key.bias", (h,)),
                (p + "attention.self.value.weight", (h, h)), (p + "attention.self.value.bias", (h,)),
                (p + "attention.output.dense.weight", (h, h)),
                (p + "attention.output.dense.bias", (h,)),
                (p + "attention.output.LayerNorm.weight", (h,)),
                (p + "attention.output.LayerNorm.bias", (h,)),
                (p + "intermediate.dense.weight", (i, h)), (p + "intermediate.dense.bias", (i,)),
                (p + "output.dense.weight", (h, i)), (p + "output.dense.bias", (h,)),
                (p + "output.LayerNorm.weight", (h,)), (p + "output.LayerNorm.bias", (h,))]
    if pooler:
        out += [("pooler.dense.weight", (h, h)), ("pooler.dense.bias", (h,))]
    out += [("img_embedding.weight", (h, img_feature_dim)), ("img_embedding.bias", (h,)),
            ("LayerNorm.weight", (h,)), ("LayerNorm.bias", (h,))]
    return [(prefix + n, s) for n, s in out]


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def attention_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, 1, 1, K) or (B, 1, Q, K) additive bias of a 1/0 mask."""
    m = mask.float()
    m = m[:, None, None, :] if m.ndim == 2 else m[:, None, :, :]
    return (1.0 - m) * NEG


def embed_text(W: Dict[str, torch.Tensor], p: str, ids: torch.Tensor, types: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    positions = torch.arange(ids.shape[1], device=ids.device)[None, :]
    x = (W[p + "embeddings.word_embeddings.weight"][ids.long()]
         + W[p + "embeddings.position_embeddings.weight"][positions]
         + W[p + "embeddings.token_type_embeddings.weight"][types.long()])
    return layer_norm(x, W[p + "embeddings.LayerNorm.weight"], W[p + "embeddings.LayerNorm.bias"],
                      eps)


def embed_regions(W, p: str, feats: torch.Tensor, prec: Precision, eps: float = 1e-12):
    x = prec.linear(feats, W[p + "img_embedding.weight"], W[p + "img_embedding.bias"])
    return layer_norm(x, W[p + "LayerNorm.weight"], W[p + "LayerNorm.bias"], eps)


def encoder_layer(W, p: str, x: torch.Tensor, bias: torch.Tensor, heads: int,
                  prec: Precision, drop: Optional[Dropouts] = None, seed=None,
                  eps: float = 1e-12) -> torch.Tensor:
    b, s, h = x.shape
    d = h // heads

    def proj(name):
        y = prec.linear(x, W[p + f"attention.self.{name}.weight"],
                        W[p + f"attention.self.{name}.bias"])
        return y.reshape(b, s, heads, d).transpose(1, 2)

    q, k, v = proj("query"), proj("key"), proj("value")
    scores = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(d) + bias
    probs = torch.softmax(scores, dim=-1)
    if drop is not None:
        probs = drop.attention_probs(probs, seed)
    ctx = prec.matmul(probs, v).transpose(1, 2).reshape(b, s, h)
    attn = prec.linear(ctx, W[p + "attention.output.dense.weight"],
                       W[p + "attention.output.dense.bias"])
    if drop is not None:
        attn = drop.apply(attn, drop.hidden)
    x = prec.act(layer_norm(x + attn, W[p + "attention.output.LayerNorm.weight"],
                            W[p + "attention.output.LayerNorm.bias"], eps))
    hid = F.gelu(prec.linear(x, W[p + "intermediate.dense.weight"],
                             W[p + "intermediate.dense.bias"]))
    out = prec.linear(hid, W[p + "output.dense.weight"], W[p + "output.dense.bias"])
    if drop is not None:
        out = drop.apply(out, drop.hidden)
    return prec.act(layer_norm(x + out, W[p + "output.LayerNorm.weight"],
                               W[p + "output.LayerNorm.bias"], eps))


def backbone(W: Dict[str, torch.Tensor], p: str, ids: torch.Tensor, mask: torch.Tensor,
             types: torch.Tensor, feats: Optional[torch.Tensor], layers: int, heads: int,
             prec: Precision, drop: Optional[Dropouts] = None) -> torch.Tensor:
    """(B, L_text [+ R], hidden) sequence output of the backbone."""
    def dropped(t):  # the program drops the text's and the regions' embeddings apart
        return t if drop is None else drop.apply(t, drop.hidden, after_layernorm=True)

    x = dropped(embed_text(W, p, ids, types))
    if feats is not None:
        x = torch.cat([x, dropped(embed_regions(W, p, feats, prec))], dim=1)
    bias = attention_bias(mask)
    seeds = drop.attention_seeds(layers) if drop is not None else None
    for n in range(layers):
        x = encoder_layer(W, f"{p}encoder.layer.{n}.", x, bias, heads, prec, drop,
                          None if seeds is None else seeds[n])
    return x
