"""Matching-head Recall@K over global embeddings (mirrors aladin_tpu/eval/recall.py).

  * the buffers hold 5 caption rows per image and 5 duplicate image rows;
    unique images are every 5th row;
  * i2t: an image's rank is the best rank among its 5 ground-truth captions;
  * t2i: a caption's rank is the rank of its image among unique images;
  * R@1/5/10 = % of ranks < K, medr = floor(median) + 1, meanr = mean + 1;
  * 5-fold 1k: five consecutive 1k folds of the 5k set, metrics averaged.

Ranks are count-of-strictly-greater, rank(q, gt) = #{j : S[q, j] > S[q, gt]}
(no argsort): the reference's argsort positions everywhere except exact
score ties, where the reference resolves by buffer order.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np
import torch

# Above this (N_im, N_cap) f32 footprint compute_recall streams the score
# matrix through eval/streaming.py (the same ranks; device memory holds the
# embeddings and one tile), as aladin_tpu does.
STREAMING_SCORE_BYTES = 4 << 30


def ranks_from_score_matrix(scores: torch.Tensor,
                            captions_per_image: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i2t_ranks (N,), t2i_ranks (5N,)) from a (N_unique_images, 5N) score
    matrix whose columns are grouped 5 per image."""
    k = captions_per_image
    n = scores.shape[0]
    gt_cols = torch.arange(n, device=scores.device)[:, None] * k + torch.arange(
        k, device=scores.device)[None, :]
    gt_scores = torch.gather(scores, 1, gt_cols)  # (N, k)
    greater = torch.stack([(scores > gt_scores[:, j:j + 1]).sum(dim=1) for j in range(k)], dim=1)
    i2t = greater.min(dim=1).values

    t_scores = scores.T  # (5N, N)
    gt_img = torch.arange(t_scores.shape[0], device=scores.device) // k
    gt_s = torch.gather(t_scores, 1, gt_img[:, None])
    t2i = (t_scores > gt_s).sum(dim=1)
    return i2t, t2i


def recall_metrics(ranks) -> Dict[str, float]:
    """R@K / medr / meanr from a rank array."""
    ranks = np.asarray(ranks)
    return {
        "r1": 100.0 * float((ranks < 1).sum()) / len(ranks),
        "r5": 100.0 * float((ranks < 5).sum()) / len(ranks),
        "r10": 100.0 * float((ranks < 10).sum()) / len(ranks),
        "medr": float(np.floor(np.median(ranks)) + 1),
        "meanr": float(ranks.mean() + 1),
    }


def _assemble(i2t_ranks, t2i_ranks) -> Dict[str, float]:
    m_i2t = recall_metrics(i2t_ranks.cpu().numpy())
    m_t2i = recall_metrics(t2i_ranks.cpu().numpy())
    out = {f"i2t_{k}": v for k, v in m_i2t.items()}
    out.update({f"t2i_{k}": v for k, v in m_t2i.items()})
    out["rsum"] = (m_i2t["r1"] + m_i2t["r5"] + m_i2t["r10"]
                   + m_t2i["r1"] + m_t2i["r5"] + m_t2i["r10"])
    return out


def compute_recall(img_embs, cap_embs, captions_per_image: int = 5,
                   device="cuda") -> Dict[str, float]:
    """Both directions + rsum from grouped (5N, D) global embeddings (host
    arrays or tensors), scored as an f32 matmul on ``device``; corpora whose
    score matrix would exceed ``STREAMING_SCORE_BYTES`` stream."""
    k = captions_per_image
    n_cap = int(np.shape(cap_embs)[0])
    if 4.0 * (n_cap // k) * n_cap > STREAMING_SCORE_BYTES:
        from aladin_torch.eval.streaming import streaming_matching_recall

        return streaming_matching_recall(img_embs[::k], cap_embs, k, device=device)
    ims = torch.as_tensor(img_embs[::k], dtype=torch.float32, device=device)
    caps = torch.as_tensor(cap_embs, dtype=torch.float32, device=device)
    return _assemble(*ranks_from_score_matrix(ims @ caps.T, k))


def recall_1k_5fold(img_embs, cap_embs, fold: int = 5000, device="cuda") -> Dict[str, float]:
    """5 x 1k folds of the 5k test set, averaged."""
    keys = ("i2t_r1", "i2t_r5", "i2t_r10", "t2i_r1", "t2i_r5", "t2i_r10")
    acc = {k: 0.0 for k in keys}
    n_folds = max(len(img_embs) // fold, 1)
    fold = min(fold, len(img_embs))
    if len(img_embs) % fold:
        logging.getLogger("vlpretrain").warning(
            "recall_1k_5fold: %d trailing rows (of %d) fall outside the %d complete folds and "
            "are excluded from the averaged metrics",
            len(img_embs) - n_folds * fold, len(img_embs), n_folds)
    for i in range(n_folds):
        m = compute_recall(img_embs[i * fold:(i + 1) * fold], cap_embs[i * fold:(i + 1) * fold],
                           device=device)
        for k in keys:
            acc[k] += m[k]
    out = {k: v / n_folds for k, v in acc.items()}
    out["rsum"] = sum(out[k] for k in keys)
    return out
