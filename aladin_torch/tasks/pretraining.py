"""OSCAR+ pretraining: masked LM + contrastive sequence relation (mirrors
aladin_tpu/tasks/pretraining.py).

Behavioral contract (ref:oscar/modeling/modeling_bert.py:927-1020
BertImgForPreTraining, ref:oscar/datasets/oscar_tsv.py:619-659 random_word,
ref:oscar/run_oscarplus_pretrain.py):

  * heads: the tied-embedding MLM head over the text positions and a
    Linear(hidden, num_contrast_classes) sequence-relation classifier over
    the pooled CLS, under pytorch_transformers' names (``bert.*``,
    ``cls.predictions.*``, ``cls.seq_relationship``), so that an OSCAR+
    pretraining checkpoint's keys load;
  * loss = CE over the masked positions (label -1 = not masked), as the
    masked sum over max(masked count, 1), so a batch with no masked token
    gives 0 and not nan, + the mean CE of the sequence relation;
  * masking: each text token is masked with p=0.15 -> 80% [MASK] / 10%
    random / 10% kept, label = original id, else label -1;
  * the "contrastive" signal: with p=0.5 the tag/OD-label segment is
    swapped for another image's, label 1 (polluted) vs 0 (matched).

The train step (``make_pretrain_step``) runs forward, loss, backward and
AdamW eagerly. Data parallelism (``mesh=``): each rank holds B / dp rows of
the global batch, and the loss is the global batch's, as aladin_tpu's SPMD
step computes it. The masked count and the row count are summed over the
ranks before the backward, each rank backpropagates its own masked CE sum
over the global count and its relation CE sum over the global B, and one
all-reduce of the flat gradients gives the loss's gradient on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aladin_torch.models.bert_img import BertImgConfig, BertImgModel
from aladin_torch.parallel.mesh import Mesh, all_reduce_sum_
from aladin_torch.tasks.captioning import BertMLMHead
from aladin_torch.train.schedule import AdamW
from aladin_torch.train.step import average_gradients, compute_autocast


class BertPreTrainingHeads(nn.Module):
    def __init__(self, cfg: BertImgConfig, num_contrast_classes: int):
        super().__init__()
        self.predictions = BertMLMHead(cfg)
        self.seq_relationship = nn.Linear(cfg.hidden_size, num_contrast_classes)


class BertImgForPreTraining(nn.Module):
    def __init__(self, cfg: BertImgConfig, num_contrast_classes: int = 2):
        super().__init__()
        self.bert = BertImgModel(cfg)
        self.cls = BertPreTrainingHeads(cfg, num_contrast_classes)

    def forward(self, input_ids, attention_mask, token_type_ids, img_feats
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """((B, L_text, vocab) f32 MLM logits, (B, num_contrast_classes)
        relation logits)."""
        seq, pooled, _, _ = self.bert(input_ids, attention_mask, token_type_ids, img_feats)
        text_len = input_ids.shape[1]
        mlm = self.cls.predictions(seq[:, :text_len], self.bert.embeddings.word_embeddings.weight)
        return mlm, self.cls.seq_relationship(pooled)


def pretraining_loss_sums(mlm_logits, rel_logits, masked_lm_labels, next_sentence_label):
    """(masked CE sum, masked count, relation CE sum) of a batch.

    ``masked_lm_labels`` may carry the reference's full-stream layout (text
    labels then -1 over every image slot, ref:oscar_tsv.py:758); the MLM
    head only scores text positions, and the image-slot labels are -1 by
    construction, so the tail is sliced off here."""
    v = mlm_logits.shape[-1]
    labels = masked_lm_labels[:, : mlm_logits.shape[1]].reshape(-1).long()
    active = labels >= 0
    per_tok = F.cross_entropy(mlm_logits.reshape(-1, v).float(), labels.clamp(min=0),
                              reduction="none")
    mlm_sum = torch.where(active, per_tok, torch.zeros_like(per_tok)).sum()
    rel_sum = F.cross_entropy(rel_logits.float(), next_sentence_label.long(), reduction="sum")
    return mlm_sum, active.sum(), rel_sum


def pretraining_loss(mlm_logits, rel_logits, masked_lm_labels, next_sentence_label):
    """(total, mlm, rel): CE(ignore_index=-1) + CE, the reference composition."""
    mlm_sum, count, rel_sum = pretraining_loss_sums(mlm_logits, rel_logits, masked_lm_labels,
                                                    next_sentence_label)
    mlm = mlm_sum / count.clamp(min=1)
    rel = rel_sum / rel_logits.shape[0]
    return mlm + rel, mlm, rel


def make_pretrain_step(model: BertImgForPreTraining, optimizer: AdamW,
                       compute_dtype: Optional[torch.dtype] = None, mesh: Optional[Mesh] = None):
    """step(ids, mask, seg, feats, mlm_labels, rel_labels) -> {"loss",
    "mlm_loss", "rel_loss"} as device scalars, the global batch's with
    ``mesh``, after one AdamW update. ``compute_dtype=torch.bfloat16`` runs
    the forward under autocast over the f32 parameters."""
    dp = mesh.size if mesh is not None else 1

    def step(ids, mask, seg, feats, mlm_labels, rel_labels) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        with compute_autocast(ids.device, compute_dtype):
            mlm_logits, rel_logits = model(ids, mask, seg, feats)
        mlm_sum, count, rel_sum = pretraining_loss_sums(mlm_logits, rel_logits, mlm_labels,
                                                        rel_labels)
        # [masked count, rows, masked CE sum, relation CE sum], over every rank
        totals = torch.stack([count.float(), torch.ones_like(rel_sum) * rel_logits.shape[0],
                              mlm_sum.detach(), rel_sum.detach()])
        if mesh is not None:
            totals = all_reduce_sum_(mesh, totals)
        denom = totals[0].clamp(min=1)
        # dp times this rank's share: the gradient average below divides by dp
        (dp * (mlm_sum / denom + rel_sum / totals[1])).backward()
        if mesh is not None:
            average_gradients(mesh, [p.grad for p in optimizer.params if p.grad is not None])
        optimizer.step()
        mlm, rel = totals[2] / denom, totals[3] / totals[1]
        return {"loss": mlm + rel, "mlm_loss": mlm, "rel_loss": rel}

    return step


def random_word_mask(token_ids: np.ndarray, vocab_size: int, rng: np.random.RandomState,
                     mask_id: int, special_ids=(0,), prob: float = 0.15):
    """BERT masking over a 1-D id array (ref:oscar_tsv.py:619-659):
    p=0.15 per token -> 80% [MASK] / 10% random / 10% keep; labels hold the
    original id at masked positions, -1 elsewhere. ``special_ids`` ([PAD]
    etc.) are never masked."""
    ids = token_ids.copy()
    labels = np.full_like(ids, -1, dtype=np.int64)
    for i, tok in enumerate(ids):
        if tok in special_ids:
            continue
        if rng.rand() < prob:
            labels[i] = tok
            r = rng.rand()
            if r < 0.8:
                ids[i] = mask_id
            elif r < 0.9:
                ids[i] = rng.randint(vocab_size)
            # else keep
    return ids, labels


def pollute_tags(tag_ids_batch: np.ndarray, rng: np.random.RandomState,
                 prob: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """With p=prob swap an example's tag segment for another example's
    (label 1 = polluted), the QA/contrastive signal of OSCAR+ pretraining."""
    n = tag_ids_batch.shape[0]
    out = tag_ids_batch.copy()
    labels = np.zeros(n, np.int64)
    for i in range(n):
        if rng.rand() < prob and n > 1:
            j = rng.randint(n - 1)
            if j >= i:
                j += 1
            out[i] = tag_ids_batch[j]
            labels[i] = 1
    return out, labels
