"""The entangled OSCAR teacher: joint (caption, image) pair scoring (mirrors
aladin_tpu/tasks/oscar_teacher.py).

Two reference capabilities live here:

1. ``teacher_scores``: the in-batch B x B teacher of attention distillation
   (ref:alad/train.py:340-384 get_teacher_scores) - every (caption j,
   image i) pair runs through the JOINT encoder; the matched probability
   forms a B x B score matrix, and the last layer's head-mean text->region
   attention block is returned for AttentionDistillationLoss. The
   reference chunks by 40 pairs to dodge OOM; here a loop over row chunks
   keeps the memory bounded.

2. ``cross_scores``: the legacy OSCAR retrieval evaluation's N_img x N_cap
   pair-probability matrix (ref:oscar/run_retrieval.py:107-112,246-293
   cross_image_eval + compute_ranks) - quadratic in the corpus, the reason
   ALADIN's disentangled design exists, kept for baseline parity. The pair
   streams are tensorized on the host a chunk at a time; the chunk's
   probabilities stay on the device until the end, so the host tensorizes
   the next chunk while the card scores this one.

The scorer reads the attention probabilities (``output_attentions``), so it
runs the plain attention path: with ``fused_attention`` on, the backbone
raises (models/bert_img.py).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from aladin_torch.models.bert_img import ImageBertClassifier


def make_pair_scorer(model: ImageBertClassifier, text_len: int):
    """fn(ids, mask, seg, feats) -> (probs, att), in eval mode.

    probs: (N,) matched-pair probability (softmax class 1,
    ref:train.py:362-365). att: (N, text_len - 1, R) last-layer head-mean
    attention of text tokens 1..text_len over the region block
    (ref:train.py:373-377 semantics with static shapes)."""

    @torch.no_grad()
    def score(ids, mask, seg, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        logits, _, _, attn = model(ids, mask, seg, feats, output_attentions=True)
        probs = torch.softmax(logits.float(), dim=-1)[:, 1]
        last = attn[-1].float().mean(dim=1)  # (N, S, S) head-mean
        return probs, last[:, 1:text_len, text_len:]  # text (minus CLS) -> regions

    return score


def teacher_scores(model: ImageBertClassifier, pair_ids, pair_mask, pair_seg, pair_feats,
                   batch_side: int, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, B) score matrix + (B, B, W, R) teacher attentions over chunks of
    ``chunk`` joint streams (row-major, image major; ref:train.py:340-384)."""
    n = pair_ids.shape[0]
    assert n == batch_side * batch_side
    assert n % chunk == 0, (n, chunk)
    scorer = make_pair_scorer(model, pair_ids.shape[1])
    parts = [scorer(pair_ids[s:s + chunk], pair_mask[s:s + chunk], pair_seg[s:s + chunk],
                    pair_feats[s:s + chunk]) for s in range(0, n, chunk)]
    probs = torch.cat([p for p, _ in parts]).reshape(batch_side, batch_side)
    atts = torch.cat([a for _, a in parts])
    return probs, atts.reshape(batch_side, batch_side, *atts.shape[1:])


def cross_scores(model: ImageBertClassifier, make_pair: Callable, n_images: int,
                 n_captions: int, chunk: int = 64) -> np.ndarray:
    """The full N_img x N_cap matched-probability matrix, the joint streams
    built on the host a chunk at a time (they cannot pre-materialize: N * M
    joint encodings). ``make_pair(img_idx, cap_idx)`` -> (ids, mask, seg,
    feats) numpy. Used by the legacy-retrieval baseline
    (tasks/retrieval_oscar.py)."""
    device = next(model.parameters()).device
    text_len = make_pair(0, 0)[0].shape[0]
    scorer = make_pair_scorer(model, text_len)
    pairs = [(i, c) for i in range(n_images) for c in range(n_captions)]
    parts = []
    for s in range(0, len(pairs), chunk):
        batch = [np.stack(x) for x in zip(*(make_pair(i, c) for i, c in pairs[s:s + chunk]))]
        parts.append(scorer(*(torch.from_numpy(a).to(device) for a in batch))[0])
    # pairs are image-major, one row of the matrix after the other
    return torch.cat(parts).float().cpu().numpy().reshape(n_images, n_captions)
