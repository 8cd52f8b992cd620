"""METEOR scorer, nltk-algorithm-faithful, no corpus downloads required (a
copy of aladin_tpu/eval/meteor.py whose nltk import is lazy).

The reference's relevance-matrix builder scores method 'meteor' with
nltk.translate.meteor_score (ref:alad/evaluate_utils/compute_relevance.py:
36-40). That implementation needs the WordNet corpus on disk for its synonym
stage; in a zero-egress image it raises LookupError. This module reimplements
the same three-stage alignment algorithm (Banerjee & Lavie 2005, as shipped
in nltk.translate.meteor_score):

  1. exact token match,
  2. Porter-stem match on the leftovers (nltk's PorterStemmer is pure code -
     no data files),
  3. WordNet-synonym match on the remaining leftovers, used only when the
     WordNet corpus is actually loadable (probed once), so scores degrade
     gracefully to exact+stem instead of crashing.

Score: F_mean * (1 - gamma * frag^beta) with alpha=0.9, beta=3, gamma=0.5
(nltk defaults). Parity with nltk is locked by tests on inputs whose
hypothesis fully aligns in stages 1-2 (where nltk runs without WordNet).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple, Union

_stemmer = None
_wordnet = None
_wordnet_probed = False


def _stem(word: str) -> str:
    """nltk's Porter stem of ``word``; nltk is imported at the first call,
    and its absence raises an ImportError that names it."""
    global _stemmer
    if _stemmer is None:
        try:
            from nltk.stem.porter import PorterStemmer
        except ImportError as e:
            raise ImportError("METEOR needs nltk (its PorterStemmer); install nltk") from e
        _stemmer = PorterStemmer()
    return _stemmer.stem(word)


def _get_wordnet():
    """The WordNet corpus reader, or None when its data files are absent."""
    global _wordnet, _wordnet_probed
    if not _wordnet_probed:
        _wordnet_probed = True
        try:
            from nltk.corpus import wordnet

            wordnet.synsets("dog")  # force-load; raises LookupError w/o data
            _wordnet = wordnet
        except Exception:
            _wordnet = None
    return _wordnet


Enum = List[Tuple[int, str]]


def _tokens(s: Union[str, Sequence[str]]) -> List[str]:
    """str -> lower().split() (the pre-3.6 nltk preprocess=str.lower
    behavior the reference era used); token sequences pass through."""
    if isinstance(s, str):
        return s.lower().split()
    return list(s)


def _match_enums(henum: Enum, renum: Enum, same) -> Tuple[list, Enum, Enum]:
    """Greedy first-match alignment (nltk _match_enums structure): iterate
    hypothesis tokens, claim the first unused reference token that matches."""
    matches = []
    used = set()
    h_left: Enum = []
    for hi, hw in henum:
        hit = None
        for rj, rw in renum:
            if rj not in used and same(hw, rw):
                hit = (hi, rj)
                used.add(rj)
                break
        if hit is not None:
            matches.append(hit)
        else:
            h_left.append((hi, hw))
    r_left = [(rj, rw) for rj, rw in renum if rj not in used]
    return matches, h_left, r_left


def _align_words(hyp: List[str], ref: List[str]) -> list:
    henum = list(enumerate(hyp))
    renum = list(enumerate(ref))
    exact, henum, renum = _match_enums(henum, renum, lambda a, b: a == b)
    stem, henum, renum = _match_enums(
        [(i, _stem(w)) for i, w in henum],
        [(j, _stem(w)) for j, w in renum],
        lambda a, b: a == b,
    )
    wn = _get_wordnet()
    syn = []
    if wn is not None and henum and renum:
        # lemma set once per HYPOTHESIS token (nltk does the same), not per
        # (hyp, ref) pair — the WordNet lookup is the stage's whole cost
        lemma_cache = {}

        def lemmas_of(hw):
            if hw not in lemma_cache:
                lemma_cache[hw] = {
                    lemma.name()
                    for ss in wn.synsets(hw)
                    for lemma in ss.lemmas()
                    if lemma.name().find("_") < 0
                } | {hw}
            return lemma_cache[hw]

        syn, henum, renum = _match_enums(
            henum, renum, lambda hw, rw: rw in lemmas_of(hw))
    return sorted(exact + stem + syn, key=lambda p: p[0])


def _count_chunks(matches: list) -> int:
    """Number of monotone contiguous runs in the (hyp_idx, ref_idx) pairs
    (nltk _count_chunks)."""
    chunks = 1
    for (h0, r0), (h1, r1) in zip(matches[:-1], matches[1:]):
        if not (h1 == h0 + 1 and r1 == r0 + 1):
            chunks += 1
    return chunks


def single_meteor_score(
    reference: Union[str, Sequence[str]],
    hypothesis: Union[str, Sequence[str]],
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
) -> float:
    ref = _tokens(reference)
    hyp = _tokens(hypothesis)
    matches = _align_words(hyp, ref)
    m = len(matches)
    if m == 0 or not hyp or not ref:
        return 0.0
    precision = m / len(hyp)
    recall = m / len(ref)
    fmean = (precision * recall) / (alpha * precision + (1 - alpha) * recall)
    frag = _count_chunks(matches) / m
    penalty = gamma * frag**beta
    return (1.0 - penalty) * fmean


def meteor_score(
    references: Iterable[Union[str, Sequence[str]]],
    hypothesis: Union[str, Sequence[str]],
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
) -> float:
    """Max single-reference score (the nltk meteor_score contract the
    reference calls: meteor_score(cur_captions, query_caption[0]))."""
    return max(
        single_meteor_score(r, hypothesis, alpha=alpha, beta=beta, gamma=gamma)
        for r in references
    )


class Meteor:
    """COCO-caption-style API (dicts id -> [sentences])."""

    def compute_score(self, gts: dict, res: dict):
        import numpy as np

        ids = sorted(gts.keys())
        scores = [meteor_score(gts[i], res[i][0]) for i in ids]
        return float(np.mean(scores)), np.array(scores)

    @staticmethod
    def method() -> str:
        return "METEOR"
