"""Offline builder of NDCG relevance matrices (mirrors
aladin_tpu/eval/relevance.py).

For every (query caption set, candidate caption set) pair, a caption-overlap
relevance written into a raw float32 memmap of shape (n_queries, n_images)
as ``{dataset}-{split}-{method}.npy`` (no ``.npy`` header: the reader
memmaps the file raw, as the reference does), read by ``eval/dcg.py``.

  * ``rougeL``: the max over the query's sentences of ROUGE-L(query
    sentence, the image's captions) (``eval/rouge.py``);
  * ``meteor`` and ``spice`` need nltk's METEOR and the SPICE jar, which
    are not ported yet (ROADMAP.md, queue 1, item 10): they raise.

Queries run in a process pool when ``num_workers`` > 1.
"""

from __future__ import annotations

import os
from multiprocessing import Pool
from typing import Dict, List, Sequence

import numpy as np

from aladin_torch.eval.rouge import Rouge

METHODS = ("rougeL", "meteor", "spice")

_WORKER: Dict[str, object] = {}


def _init_worker(captions_per_image: List[List[str]]):
    _WORKER["caps"] = captions_per_image
    _WORKER["scorer"] = Rouge()


def _score_query(args):
    qi, query_caps = args
    caps: List[List[str]] = _WORKER["caps"]  # type: ignore[assignment]
    rouge: Rouge = _WORKER["scorer"]  # type: ignore[assignment]
    row = np.zeros(len(caps), np.float32)
    for ii, refs in enumerate(caps):
        row[ii] = max(rouge.calc_score([q], refs) for q in query_caps)
    return qi, row


def compute_relevances(
    query_caption_sets: Sequence[List[str]],
    image_caption_sets: Sequence[List[str]],
    out_path: str,
    method: str = "rougeL",
    num_workers: int = 4,
) -> np.ndarray:
    """Build the (n_queries, n_images) relevance memmap at ``out_path``."""
    if method not in METHODS:
        raise ValueError(f"{method}: expected one of {METHODS}")
    if method != "rougeL":
        raise NotImplementedError(f"{method} relevances need nltk's METEOR / the SPICE jar, "
                                  "not ported yet (ROADMAP.md, queue 1, item 10)")
    n_q, n_i = len(query_caption_sets), len(image_caption_sets)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    mm = np.memmap(out_path, mode="w+", dtype=np.float32, shape=(n_q, n_i))
    jobs = list(enumerate(query_caption_sets))
    if num_workers > 1:
        with Pool(num_workers, initializer=_init_worker,
                  initargs=(list(image_caption_sets),)) as p:
            for qi, row in p.imap_unordered(_score_query, jobs, chunksize=8):
                mm[qi] = row
    else:
        _init_worker(list(image_caption_sets))
        for job in jobs:
            qi, row = _score_query(job)
            mm[qi] = row
    mm.flush()
    return mm
