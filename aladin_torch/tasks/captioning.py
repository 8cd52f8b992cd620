"""Image captioning's masked-LM head (mirrors the model part of
aladin_tpu/tasks/captioning.py; the captioning model, its loss and decoding
are not ported yet: ROADMAP.md, queue 1, item 9.3).

The MLM head is BERT's BertLMPredictionHead: dense -> the backbone's
activation -> LayerNorm, then a decoder tied to the word embeddings plus a
free bias (tie_weights, ref:oscar/modeling/modeling_bert.py:618-621). The
tied matrix is the embedding table itself, passed in at each call, so the
state dict holds it once, under ``bert.``; the head's own names are
pytorch_transformers' (``transform.dense``, ``transform.LayerNorm``,
``bias``), which put it at ``cls.predictions.*`` inside a model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aladin_torch.models.bert_img import BertImgConfig, ffn_act


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        return self.LayerNorm(ffn_act(self.dense(x), self.act))  # follows the backbone's act


class BertMLMHead(nn.Module):
    """(…, hidden) -> (…, vocab) f32 logits: transform, then the product
    with the tied (vocab, hidden) word embeddings plus ``bias``."""

    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.transform = BertPredictionHeadTransform(cfg)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, x: torch.Tensor, word_embeddings: torch.Tensor) -> torch.Tensor:
        return F.linear(self.transform(x), word_embeddings).float() + self.bias
