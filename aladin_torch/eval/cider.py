"""CIDEr-D scorer (consensus-based caption metric; a copy of
aladin_tpu/eval/cider.py).

Equivalent capability to ref:oscar/utils/cider/* (CiderD): 1..4-gram TF-IDF
vectors per sentence, cosine similarity against each reference with n-gram
count clipping and a Gaussian length penalty (sigma=6), averaged over n and
references, scaled by 10. Document frequencies come from the reference
corpus ('corpus' mode). Also powers the SCST reward
(tasks/scst.py; ref:oscar/utils/caption_evaluate.py:115-197).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


def _ngrams(tokens: List[str], n_max: int = 4) -> Dict[Tuple[str, ...], int]:
    counts: Dict[Tuple[str, ...], int] = defaultdict(int)
    for n in range(1, n_max + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


class CiderD:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def _compute_doc_freq(self, refs_per_image: List[List[str]]):
        self.doc_freq: Dict[Tuple[str, ...], int] = defaultdict(int)
        for refs in refs_per_image:
            seen = set()
            for ref in refs:
                seen.update(_ngrams(ref.split(), self.n).keys())
            for g in seen:
                self.doc_freq[g] += 1
        self.log_ref_len = math.log(max(len(refs_per_image), 1))

    def _vec(self, sentence: str):
        counts = _ngrams(sentence.split(), self.n)
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for g, c in counts.items():
            df = math.log(max(self.doc_freq.get(g, 0), 1.0))
            k = len(g) - 1
            vec[k][g] = float(c) * (self.log_ref_len - df)
            norm[k] += vec[k][g] ** 2
            if k == 1:
                # sentence length = BIGRAM term frequency (= tokens-1), the
                # reference's convention (pycocoevalcap cider_scorer `if
                # n == 1` with 1-indexed n); unigram counting diverges for
                # empty/1-token candidates in the length penalty
                length += c
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vh, nh, lh, vr, nr, lr):
        delta = lh - lr
        out = np.zeros(self.n)
        for k in range(self.n):
            s = 0.0
            for g, w in vh[k].items():
                # CIDEr-D clips the hypothesis count term at the reference's
                s += min(w, vr[k].get(g, 0.0)) * vr[k].get(g, 0.0)
            if nh[k] and nr[k]:
                s /= nh[k] * nr[k]
            out[k] = s * math.exp(-(delta**2) / (2 * self.sigma**2))
        return out

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        """gts: id -> [ref sentences]; res: id -> [hypothesis]."""
        ids = sorted(gts.keys())
        self._compute_doc_freq([gts[i] for i in ids])
        scores = []
        for i in ids:
            hyp = res[i][0]
            vh, nh, lh = self._vec(hyp)
            acc = np.zeros(self.n)
            for ref in gts[i]:
                vr, nr, lr = self._vec(ref)
                acc += self._sim(vh, nh, lh, vr, nr, lr)
            score = np.mean(acc / max(len(gts[i]), 1)) * 10.0
            scores.append(score)
        arr = np.asarray(scores)
        return float(arr.mean()), arr
