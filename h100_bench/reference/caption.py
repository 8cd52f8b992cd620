"""Plain PyTorch VinVL captioner (OSCAR's ``BertForImageCaptioning``):
the backbone of ``reference/bert.py`` over [caption slots | OD labels |
regions] under the decode's 2-D block mask, and the MLM head tied to the
word embeddings (transform: dense, gelu, LayerNorm eps 1e-12; then the
product with the word-embedding table plus a bias). Decoding is masked-LM
style: the logits of caption position t come from a forward whose slot t
holds [MASK] and whose earlier slots hold the caption so far."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from h100_bench.reference import bert
from h100_bench.reference.precision import Precision

BERT = "bert."
HEAD = "cls.predictions."
MASK, CLS = 103, 101


def spec(c: dict):
    h = c["hidden_size"]
    out = bert.spec(BERT, c["vocab_size"], h, c["num_hidden_layers"], c["intermediate_size"],
                    c["max_position_embeddings"], c["type_vocab_size"], c["img_feature_dim"])
    return out + [(HEAD + "bias", (c["vocab_size"],)),
                  (HEAD + "transform.dense.weight", (h, h)), (HEAD + "transform.dense.bias", (h,)),
                  (HEAD + "transform.LayerNorm.weight", (h,)),
                  (HEAD + "transform.LayerNorm.bias", (h,))]


def mlm_head(W: Dict[str, torch.Tensor], x: torch.Tensor, prec: Precision) -> torch.Tensor:
    y = F.gelu(prec.linear(x, W[HEAD + "transform.dense.weight"], W[HEAD + "transform.dense.bias"]))
    y = F.layer_norm(y, (y.shape[-1],), W[HEAD + "transform.LayerNorm.weight"],
                     W[HEAD + "transform.LayerNorm.bias"], 1e-12)
    return prec.linear(y, W[BERT + "embeddings.word_embeddings.weight"], W[HEAD + "bias"])


@torch.no_grad()
def position_logits(W, c: dict, inp: Dict[str, torch.Tensor], tokens: torch.Tensor, n: int,
                    prec: Precision) -> torch.Tensor:
    """(1, n, V) logits at caption positions 1..n of one image's caption
    ``tokens`` (1, max_seq_a): row t - 1 is the full forward over
    [CLS, tokens 1..t-1, MASK ...], read at slot t."""
    la = c["max_seq_a_length"]
    dev = tokens.device
    slots = torch.arange(la, device=dev)[None, :]
    t = torch.arange(1, n + 1, device=dev)[:, None]
    cap = torch.where(slots < t, tokens.expand(n, la), MASK)
    cap[:, 0] = CLS
    ids = torch.cat([cap, inp["od_ids"].long().expand(n, -1)], dim=1)
    types = torch.cat([torch.zeros_like(cap), inp["od_seg"].long().expand(n, -1)], dim=1)
    feats = inp["img_feats"].expand(n, -1, -1)
    mask = inp["attn_mask"].expand(n, -1, -1)
    with prec.context():
        seq = bert.backbone(W, BERT, ids, mask, types, feats, c["num_hidden_layers"],
                            c["num_attention_heads"], prec)
        rows = seq[torch.arange(n, device=dev), t[:, 0]]
        return mlm_head(W, rows, prec).float()[None]
