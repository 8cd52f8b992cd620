"""ROUGE-L scorer (LCS-based F-measure, beta = 1.2; a copy of
aladin_tpu/eval/rouge.py).

Equivalent capability to the reference's evaluate_utils/rouge.py
(ref:alad/evaluate_utils/rouge.py:37-76): candidate vs multi-reference
ROUGE-L with the union... strictly, the reference takes the MAX precision and
recall over references before the F combination. Pure numpy/python, used by
the offline relevance-matrix builder (eval/relevance.py).
"""

from __future__ import annotations

from typing import List, Sequence


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Length of the longest common subsequence, O(len(a)*len(b)) DP with
    two rolling rows."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


class Rouge:
    """ROUGE-L with beta=1.2 (the caption-metric convention)."""

    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        """candidate: [sentence]; refs: [sentence, ...].

        Tokenization matches the reference exactly - lowercase then split on
        single spaces (ref:alad/evaluate_utils/rouge.py:58-62 ".lower()
        .split(' ')") - so relevance matrices agree on capitalized captions.
        """
        assert len(candidate) == 1
        assert len(refs) > 0
        cand_tokens = candidate[0].lower().split(" ")
        prec, rec = [], []
        for ref in refs:
            ref_tokens = ref.lower().split(" ")
            lcs = _lcs_len(cand_tokens, ref_tokens)
            prec.append(lcs / len(cand_tokens) if cand_tokens else 0.0)
            rec.append(lcs / len(ref_tokens) if ref_tokens else 0.0)
        p, r = max(prec), max(rec)
        if p != 0 and r != 0:
            return ((1 + self.beta**2) * p * r) / (r + self.beta**2 * p)
        return 0.0

    def compute_score(self, gts: dict, res: dict):
        """COCO-caption API: dicts id -> [sentences]; returns (mean, per-id)."""
        ids = sorted(gts.keys())
        scores = [self.calc_score(res[i], gts[i]) for i in ids]
        import numpy as np

        return float(np.mean(scores)), np.array(scores)

    @staticmethod
    def method() -> str:
        return "Rouge"
