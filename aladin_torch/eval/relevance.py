"""Offline builder of NDCG relevance matrices (a copy of
aladin_tpu/eval/relevance.py).

Equivalent capability to ref:alad/evaluate_utils/compute_relevance.py: for
every (query caption-set, candidate caption-set) pair, a caption-overlap
relevance score written into an np.memmap of shape (n_queries, n_images) as
``{dataset}-{split}-{method}.npy``, consumable by eval/dcg.py. Methods
(ref:compute_relevance.py:25-54):

  * ``rougeL``: max over the query's sentences of ROUGE-L(query sentence,
    image's captions) - native (eval/rouge.py);
  * ``meteor``: nltk-faithful METEOR (eval/meteor.py, no corpus downloads) -
    the reference calls nltk.translate.meteor_score;
  * ``spice``: the Java SPICE jar per query row (eval/spice.py protocols,
    ref:spice.py:78-85); gated on the jar being present - host-side
    preprocessing only, never on the device path (SURVEY.md S2.4).

Parallelism: a process pool over queries (the reference uses
multiprocessing.Pool with worker-global init, ref:compute_relevance.py:56-59,
112-115).
"""

from __future__ import annotations

import os
from multiprocessing import Pool
from typing import Dict, List, Sequence

import numpy as np

from aladin_torch.eval.rouge import Rouge

METHODS = ("rougeL", "meteor", "spice")

_WORKER: Dict[str, object] = {}


def _init_worker(captions_per_image: List[List[str]], method: str):
    _WORKER["caps"] = captions_per_image
    _WORKER["method"] = method
    if method == "rougeL":
        _WORKER["scorer"] = Rouge()
    elif method == "meteor":
        from aladin_torch.eval.meteor import meteor_score

        _WORKER["scorer"] = meteor_score


def _score_query(args):
    qi, query_caps = args
    caps: List[List[str]] = _WORKER["caps"]  # type: ignore[assignment]
    method = _WORKER["method"]
    row = np.zeros(len(caps), np.float32)
    if method == "rougeL":
        rouge: Rouge = _WORKER["scorer"]  # type: ignore[assignment]
        for ii, refs in enumerate(caps):
            # max over the query's sentences of ROUGE-L(query sentence, refs)
            row[ii] = max(rouge.calc_score([q], refs) for q in query_caps)
    elif method == "meteor":
        meteor = _WORKER["scorer"]
        for ii, refs in enumerate(caps):
            row[ii] = max(meteor(refs, q) for q in query_caps)
    else:  # spice: one jar invocation per query sentence, elementwise max —
        # the same max-over-the-query's-sentences semantics as the other
        # methods (a single-sentence query costs exactly one invocation,
        # the reference's layout, ref:compute_relevance.py:43-54)
        from aladin_torch.eval.spice import Spice

        gts = {ii: refs for ii, refs in enumerate(caps)}
        for q in query_caps:
            res = {ii: [q] for ii in gts}
            _, results = Spice().compute_score(gts, res)
            for item in results:
                ii = int(item["image_id"])
                row[ii] = max(row[ii], float(item["scores"]["All"]["f"]))
    return qi, row


def compute_relevances(
    query_caption_sets: Sequence[List[str]],
    image_caption_sets: Sequence[List[str]],
    out_path: str,
    method: str = "rougeL",
    num_workers: int = 4,
) -> np.ndarray:
    """Build (n_queries, n_images) relevance memmap at out_path."""
    if method not in METHODS:
        raise ValueError(f"{method}: expected one of {METHODS}")
    if method == "spice":
        from aladin_torch.eval.spice import SPICE_JAR, _require

        _require(SPICE_JAR, "SPICE relevance matrices")
    n_q, n_i = len(query_caption_sets), len(image_caption_sets)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    # RAW float32 memmap (no .npy header): the reference reader memmaps the
    # file raw despite the extension (ref:dcg.py:15-17) - match that layout.
    mm = np.memmap(out_path, mode="w+", dtype=np.float32, shape=(n_q, n_i))
    jobs = list(enumerate(query_caption_sets))
    if num_workers > 1 and method != "spice":  # the jar is its own process
        with Pool(num_workers, initializer=_init_worker,
                  initargs=(list(image_caption_sets), method)) as p:
            for qi, row in p.imap_unordered(_score_query, jobs, chunksize=8):
                mm[qi] = row
    else:
        _init_worker(list(image_caption_sets), method)
        for job in jobs:
            qi, row = _score_query(job)
            mm[qi] = row
    mm.flush()
    return mm
