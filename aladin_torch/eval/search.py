"""Two-stage retrieval search: matching-head shortlist + alignment rerank
(mirrors aladin_tpu/eval/search.py on one device).

  1. Stage 1 (shortlist): ``q_glob @ corpus.globals.T`` in f32 and a top-k,
     one dot product per (query, item).
  2. Stage 2 (rerank): gather the shortlist's token sets and score the
     (query, candidate) pairs only with ``ops.alignment.alignment_scores``
     (the region-word aggregation, MrSw by default), batched over the
     queries with ``torch.vmap`` and over the shortlist in blocks of
     ``RERANK_BLOCK`` candidates, so the gathered token sets and their f32
     copy inside ``alignment_scores`` stay bounded at any shortlist.

The corpus lives on the device as bf16 token sets and f32 l2-normalized
globals. Stage 1 is a true f32 product: the port never enables TF32, since
near-tied candidates reorder under reduced precision. Every top-k keeps
``lax.top_k``'s order among equal scores (``ops/topk.py``), so a corpus
with repeated rows ranks as aladin_tpu ranks it.

Exactness: with ``shortlist >= corpus size`` the two-stage result equals
full alignment-head ranking; at shortlist K it is the retrieve-and-rerank
approximation whose recall floor is the matching head's R@K.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aladin_torch.ops.alignment import alignment_scores
from aladin_torch.ops.similarity import l2norm
from aladin_torch.ops.topk import top_k

#: candidates a chunk of queries scores at once: at query_chunk 64 and 50
#: words of D 768 a block gathers 2.5 GB of bf16 token sets (5 GB as f32)
RERANK_BLOCK = 512


@dataclass
class Corpus:
    """One modality's indexed corpus, on one device.

    ``token_sets`` (N, S, D): per-token embeddings with the global matching
    embedding at slot 0 (what eval/encode.py produces). ``globals`` (N, D):
    slot-0 rows, kept separately in f32 for stage 1. ``lengths`` (N,): true
    token counts including the special tokens.
    """

    token_sets: torch.Tensor
    globals: torch.Tensor
    lengths: torch.Tensor

    @property
    def size(self) -> int:
        return self.token_sets.shape[0]

    @property
    def device(self) -> torch.device:
        return self.token_sets.device


def normalize_globals(globs: torch.Tensor) -> torch.Tensor:
    """f32 rows divided by their norm, floored at 1e-12."""
    globs = globs.float()
    return globs / torch.clamp(torch.linalg.norm(globs, dim=-1, keepdim=True), min=1e-12)


def build_corpus(embs, lengths, store_dtype=torch.bfloat16, device="cuda") -> Corpus:
    """Index one modality from eval/encode.py buffers on ``device``.

    ``embs`` (N, S, D) with the slot-0 global packing; token sets are
    l2-normalized once here (converter-loaded or f32-roundtripped buffers
    may be off by eps) and stored in ``store_dtype``; scores accumulate in
    f32.
    """
    embs = torch.as_tensor(embs, device=device)
    sets = l2norm(embs.float(), eps=1e-12).to(store_dtype)
    return Corpus(sets, normalize_globals(embs[:, 0, :]),
                  torch.as_tensor(lengths, dtype=torch.int32, device=device))


def _rerank_i2t(q_sets, q_lens, cand_sets, cand_lens, aggregation):
    """(Q, R, D) image queries vs (Q, K, W, D) caption candidates -> (Q, K)."""
    def one(im, il, caps, cls):
        return alignment_scores(im[None], caps, il[None], cls, aggregation, normalized=True)[0]

    return torch.vmap(one)(q_sets, q_lens, cand_sets, cand_lens)


def _rerank_t2i(q_sets, q_lens, cand_sets, cand_lens, aggregation):
    """(Q, W, D) caption queries vs (Q, K, R, D) image candidates -> (Q, K)."""
    def one(cap, cl, ims, ils):
        return alignment_scores(ims, cap[None], ils, cl[None], aggregation, normalized=True)[:, 0]

    return torch.vmap(one)(q_sets, q_lens, cand_sets, cand_lens)


def _search_batch(corpus: Corpus, q_sets: torch.Tensor, q_lens: torch.Tensor, *, direction: str,
                  k: int, shortlist: int, rerank: bool,
                  aggregation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    sims = torch.matmul(normalize_globals(q_sets[:, 0, :]), corpus.globals.T)
    if not rerank:
        return top_k(sims, k)

    _, short_idx = top_k(sims, shortlist)  # (Q, K)
    q_norm = l2norm(q_sets, eps=1e-12)
    fn = _rerank_i2t if direction == "i2t" else _rerank_t2i
    align = torch.cat([  # (Q, K); each block gathers (Q, block, S, D)
        fn(q_norm, q_lens, corpus.token_sets[blk], corpus.lengths[blk], aggregation)
        for blk in short_idx.split(RERANK_BLOCK, dim=1)], dim=1)
    best, pos = top_k(align, k)
    return best, torch.gather(short_idx, 1, pos)


@torch.inference_mode()
def search(corpus: Corpus, query_sets, query_lens, *, direction: str, k: int = 10,
           shortlist: int = 100, rerank: bool = True, aggregation: str = "MrSw",
           query_chunk: Optional[int] = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Retrieve the top-``k`` corpus items for each query.

    Args:
      corpus: the indexed OTHER modality (images for ``direction='t2i'``,
        captions for ``'i2t'``); the search runs on its device.
      query_sets: (Q, S, D) query token sets with the slot-0 global packing
        (a host array or a tensor).
      query_lens: (Q,) true lengths.
      direction: 'i2t' (image query, caption corpus) or 't2i'.
      k: results per query.
      shortlist: stage-1 candidate count (clamped to the corpus size); the
        two-stage result equals full alignment ranking when
        ``shortlist >= corpus.size``.
      rerank: False = matching head only.
      query_chunk: queries per batch, which bounds (with ``RERANK_BLOCK``)
        the (chunk, block, S, D) bf16 gather; None = all at once.

    Returns (scores (Q, k) f32, indices (Q, k) int32) as numpy.
    """
    if direction not in ("i2t", "t2i"):
        raise ValueError(f"direction must be 'i2t' or 't2i', got {direction!r}")
    query_sets = torch.as_tensor(query_sets, device=corpus.device)
    query_lens = torch.as_tensor(query_lens, dtype=torch.int32, device=corpus.device)
    n_q = query_sets.shape[0]
    if n_q == 0:  # an empty bucket: empty results with the clamped width
        kk = min(k, min(shortlist, corpus.size) if rerank else corpus.size)
        return np.zeros((0, kk), np.float32), np.zeros((0, kk), np.int32)
    shortlist = min(shortlist, corpus.size)
    k = min(k, corpus.size if not rerank else shortlist)
    chunk = n_q if not query_chunk else min(query_chunk, n_q)

    scores, idx = [], []
    for lo in range(0, n_q, chunk):
        qs = query_sets[lo:lo + chunk]
        ql = query_lens[lo:lo + chunk]
        pad = chunk - qs.shape[0]
        if pad:  # the tail padded to the chunk, as aladin_tpu pads it
            qs = F.pad(qs, (0, 0, 0, 0, 0, pad))
            ql = F.pad(ql, (0, pad), value=4)
        s, i = _search_batch(corpus, qs, ql, direction=direction, k=k, shortlist=shortlist,
                             rerank=rerank, aggregation=aggregation)
        scores.append(s[:chunk - pad])
        idx.append(i[:chunk - pad])
    # one copy to the host at the end: per-chunk copies would wait for each chunk
    return (torch.cat(scores).cpu().numpy(),
            torch.cat(idx).to(torch.int32).cpu().numpy())
