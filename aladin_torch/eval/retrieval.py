"""Alignment-head retrieval evaluation from one full score matrix (mirrors
aladin_tpu/eval/retrieval.py).

The (N_unique_images, N_captions) alignment matrix is computed once (the
MrSw kernel on the card) and both directions' ranks are read from it:
i2t = best rank among an image's 5 captions, t2i = rank of a caption's
image. NDCG@25 comes from an NDCG scorer over relevance matrices
(``ndcg_from_scores``); its fields are 0 only when no scorer is given, as
in the reference. ``score_fn`` replaces the scorer, as a corpus-sharded
one does (``parallel/mesh.py::sharded_mrsw_scores``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from aladin_torch.eval.recall import ranks_from_score_matrix, recall_metrics
from aladin_torch.ops.alignment import score_all_pairs
from aladin_torch.ops.kernels.alignment_kernel import (caption_buckets, mrsw_scores,
                                                      mrsw_scores_bucketed)


def ndcg_from_scores(scores: torch.Tensor, ndcg_scorer, fold_index: int,
                     retrieval: str) -> Tuple[float, float]:
    """(mean rougeL NDCG, mean spice NDCG) over the queries of one
    direction: each query's candidates sorted by score, descending, through
    ``ndcg_scorer.compute_ndcg``, whose dict is read by method name (a
    scorer with only one relevance matrix reports 0 for the other)."""
    if ndcg_scorer is None:
        return 0.0, 0.0
    s = scores.float().cpu().numpy()
    s = s if retrieval == "sentence" else s.T
    npts = scores.shape[0]
    rougel, spice = [], []
    for q in range(s.shape[0]):
        order = np.argsort(s[q])[::-1]  # aladin_tpu's order, ties included
        vals = ndcg_scorer.compute_ndcg(npts, q, order, fold_index, retrieval)
        rougel.append(float(vals.get("rougeL", 0.0)))
        spice.append(float(vals.get("spice", 0.0)))
    return float(np.mean(rougel)), float(np.mean(spice))


def retrieval_metrics_from_scores(
        scores: torch.Tensor, captions_per_image: int = 5, ndcg_scorer=None,
        fold_index: int = 0) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(i2t, t2i) metric dicts from one rank extraction; NDCG by
    ``ndcg_scorer`` with i2t's queries the images (``retrieval="sentence"``)
    and t2i's the captions (``"image"``)."""
    i2t_r, t2i_r = ranks_from_score_matrix(scores, captions_per_image)
    i2t = recall_metrics(i2t_r.cpu().numpy())
    t2i = recall_metrics(t2i_r.cpu().numpy())
    i2t["ndcg_rougel"], i2t["ndcg_spice"] = ndcg_from_scores(scores, ndcg_scorer, fold_index,
                                                             "sentence")
    t2i["ndcg_rougel"], t2i["ndcg_spice"] = ndcg_from_scores(scores, ndcg_scorer, fold_index,
                                                             "image")
    return i2t, t2i


def score_by_caption_bucket(score_fn: Callable, ims: torch.Tensor, caps: torch.Tensor,
                            il: torch.Tensor, cl: torch.Tensor) -> torch.Tensor:
    """(N_im, N_cap) f32 scores of ``score_fn(ims, caps, il, cl)`` called
    once a bucket of ``caption_buckets``, narrowest first, on the bucket's
    captions sliced to its width, the columns put back in corpus order; one
    call on the whole corpus when a single full-width bucket remains. The
    calls of aladin_tpu's ``mrsw_scores_bucketed(scorer=...)``."""
    w = caps.shape[1]
    _, bucket, kept = caption_buckets(cl.cpu().numpy(), w)
    if len(kept) == 1 and kept[0] == w:
        return score_fn(ims, caps, il, cl)
    out = torch.zeros(ims.shape[0], caps.shape[0], dtype=torch.float32, device=ims.device)
    for i, width in enumerate(kept):
        t = torch.as_tensor(np.nonzero(bucket == i)[0], device=ims.device)
        out[:, t] = score_fn(ims, caps.index_select(0, t)[:, :width], il,
                             cl.index_select(0, t)).float()
    return out


def evaluate_alignment_head(
        img_sets, cap_seqs, img_lens, cap_lens, aggregation: str = "MrSw",
        captions_per_image: int = 5, compute_dtype=None, device="cuda",
        ndcg_scorer=None, score_fn: Optional[Callable] = None,
) -> Tuple[Dict[str, float], Dict[str, float], torch.Tensor]:
    """Full alignment-head eval: (i2t metrics, t2i metrics, score matrix).

    img_sets: (5N, S_im, D) grouped buffers (duplicates dropped here),
    cap_seqs: (5N, S_s, D). As in aladin_tpu, the fused MrSw scorer
    (``mrsw_scores``) runs for 'MrSw' on the card, and for int8 anywhere (on
    the CPU as the kernel's plain version); otherwise
    ``ops.alignment.score_all_pairs`` scores in f32. ``compute_dtype``:
    torch.bfloat16 (default) or torch.int8. The caption axis is bucketed
    (``caption_buckets``) when that saves >= 25% of the padded word slots.
    ``ndcg_scorer``: a DCG scorer for the NDCG fields (None: 0).
    ``score_fn(ims, caps, il, cl)`` replaces the scorer, as in aladin_tpu
    (a corpus-sharded one: ``parallel/mesh.py::sharded_mrsw_scores``);
    with bucketing it scores each bucket (``score_by_caption_bucket``).
    """
    device = torch.device(device)
    if compute_dtype is None:
        compute_dtype = torch.bfloat16
    use_kernel = device.type == "cuda" or compute_dtype == torch.int8
    k = captions_per_image
    ims = torch.as_tensor(np.asarray(img_sets)[::k], dtype=torch.float32, device=device)
    il = torch.as_tensor(np.asarray(img_lens)[::k], device=device)
    caps = torch.as_tensor(np.asarray(cap_seqs), dtype=torch.float32, device=device)
    cl = torch.as_tensor(np.asarray(cap_lens), device=device)

    bucket_captions = (caption_buckets(cap_lens, caps.shape[1])[0].mean()
                       <= 0.75 * caps.shape[1])

    if score_fn is not None:
        if bucket_captions:
            scores = score_by_caption_bucket(score_fn, ims, caps, il, cl)
        else:
            scores = score_fn(ims, caps, il, cl)
    elif aggregation == "MrSw" and use_kernel:
        if bucket_captions:
            scores = mrsw_scores_bucketed(ims, caps, il, cl, compute_dtype=compute_dtype)
        else:
            scores = mrsw_scores(ims, caps, il, cl, compute_dtype=compute_dtype)
    else:
        scores = score_all_pairs(ims, caps, il, cl, aggregation, 256)

    i2t, t2i = retrieval_metrics_from_scores(scores, k, ndcg_scorer)
    return i2t, t2i, scores


def fivefold_from_scores(scores: torch.Tensor, captions_per_image: int = 5, n_folds: int = 5,
                         ndcg_scorer=None) -> Tuple[Dict[str, float], Dict[str, float]]:
    """5 x 1k-fold protocol on a full (N_im, N_cap) alignment matrix: the
    diagonal (image fold x caption fold) blocks, metrics averaged; fold f
    reads its relevances at ``fold_index`` f."""
    fold_im = scores.shape[0] // n_folds
    k = captions_per_image
    keys = ("r1", "r5", "r10", "medr", "meanr", "ndcg_rougel", "ndcg_spice")
    acc_i2t = {key: 0.0 for key in keys}
    acc_t2i = {key: 0.0 for key in keys}
    for f in range(n_folds):
        blk = scores[f * fold_im:(f + 1) * fold_im, f * fold_im * k:(f + 1) * fold_im * k]
        i2t, t2i = retrieval_metrics_from_scores(blk, k, ndcg_scorer, fold_index=f)
        for key in keys:
            acc_i2t[key] += i2t[key]
            acc_t2i[key] += t2i[key]
    return ({key: v / n_folds for key, v in acc_i2t.items()},
            {key: v / n_folds for key, v in acc_t2i.items()})
