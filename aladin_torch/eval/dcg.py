"""NDCG@rank over precomputed relevance matrices (a copy of
aladin_tpu/eval/dcg.py: numpy only).

Equivalent capability to the reference's DCG subsystem
(ref:alad/evaluate_utils/dcg.py): relevance matrices are np.memmap files
``{dataset}-{split}-{method}.npy`` of shape (n_queries, n_images), produced
offline (see eval/relevance.py); at eval time, per-query NDCG@25 is computed
from the ranking the retrieval scores induce.

Math (vectorized rewrite of the standard Blondel formulation the reference
carries, ref:dcg.py:115-217): exponential gains 2^rel - 1, log2(i + 2)
discounts, normalized by the ideal ranking's DCG.

The shipped reference pipeline constructs the scorer as None
(SURVEY.md S2.6(11)); the machinery here is live and tested.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List

import numpy as np


def dcg_from_ranking(y_true: np.ndarray, ranking: np.ndarray) -> float:
    rel = np.asarray(y_true)[np.asarray(ranking)]
    gains = 2.0 ** rel - 1.0
    discounts = np.log2(np.arange(len(ranking)) + 2.0)
    return float(np.sum(gains / discounts))


def ndcg_from_ranking(y_true: np.ndarray, ranking: np.ndarray) -> float:
    k = len(ranking)
    best_ranking = np.argsort(y_true)[::-1][:k]
    best = dcg_from_ranking(y_true, best_ranking)
    if best == 0:
        return 0.0
    return dcg_from_ranking(y_true, ranking) / best


def ndcg_score(y_true, y_score, k: int = 10, gains: str = "exponential") -> float:
    """Score-based API (ref:dcg.py:146-164)."""
    order = np.argsort(y_score)[::-1][:k]
    rel = np.take(np.asarray(y_true, dtype=np.float64), order)
    if gains == "exponential":
        g = 2.0 ** rel - 1.0
    elif gains == "linear":
        g = rel
    else:
        raise ValueError("Invalid gains option.")
    discounts = np.log2(np.arange(len(rel)) + 2.0)
    actual = float(np.sum(g / discounts))
    ideal_order = np.argsort(y_true)[::-1][:k]
    ideal_rel = np.take(np.asarray(y_true, dtype=np.float64), ideal_order)
    ig = (2.0 ** ideal_rel - 1.0) if gains == "exponential" else ideal_rel
    best = float(np.sum(ig / discounts))
    return actual / best if best else 0.0


class DCG:
    """Relevance-matrix NDCG scorer (ref:alad/evaluate_utils/dcg.py:7-33).

    Files: ``{data_root}/{dataset}/relevances/{dataset}-{split}-{method}.npy``
    memmapped as float32 (n_queries, n_images).
    """

    def __init__(self, config, n_queries: int, split: str, rank: int = 25,
                 relevance_methods: Iterable[str] = ("rougeL",),
                 rel_dir: str = None):
        self.rank = rank
        self.relevance_methods = list(relevance_methods)
        dataset = config["dataset"]["name"] if isinstance(config, dict) else config.dataset.name
        if rel_dir is None:
            root = config["dataset"].get("data", "datasets") if isinstance(config, dict) else config.dataset.data
            rel_dir = os.path.join(root, dataset, "relevances")
        self.relevances: List[np.memmap] = []
        for m in self.relevance_methods:
            f = os.path.join(rel_dir, f"{dataset}-{split}-{m}.npy")
            r = np.memmap(f, dtype=np.float32, mode="r")
            r.shape = (n_queries, -1)
            self.relevances.append(r)

    def compute_ndcg(self, npts: int, query_id: int, sorted_indexes: np.ndarray,
                     fold_index: int = 0, retrieval: str = "image") -> Dict[str, float]:
        sorted_indexes = np.asarray(sorted_indexes)[: self.rank]
        if retrieval == "image":
            qb = npts * 5 * fold_index
            rels = [r[qb + query_id, fold_index * npts : (fold_index + 1) * npts]
                    for r in self.relevances]
        elif retrieval == "sentence":
            qb = npts * fold_index
            rels = [r[fold_index * npts * 5 : (fold_index + 1) * npts * 5, qb + query_id]
                    for r in self.relevances]
        else:
            raise ValueError(retrieval)
        return {
            m: ndcg_from_ranking(rel, sorted_indexes)
            for m, rel in zip(self.relevance_methods, rels)
        }
