"""Caption evaluation orchestration: BLEU / METEOR / ROUGE-L / CIDEr-D (+SPICE)
(a copy of aladin_tpu/eval/caption_metrics.py).

Equivalent capability to ref:oscar/utils/caption_evaluate.py
(evaluate_on_coco_caption): score generated captions against the COCO
ground-truth sets and report the standard metric dict. BLEU, METEOR
(eval/meteor.py, nltk-algorithm-faithful native port), ROUGE-L and CIDEr-D
run natively; METEOR's stemmer is nltk's, and METEOR is skipped with a note
(``METEOR_skipped``) where nltk is not installed; SPICE shells out to Java
(eval/spice.py) and is skipped with a note when the jars are absent.
"""

from __future__ import annotations

import json
import math
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from aladin_torch.eval.cider import CiderD
from aladin_torch.eval.meteor import Meteor
from aladin_torch.eval.rouge import Rouge


def _ngram_counts(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu_score(hypotheses: Sequence[str], references: Sequence[List[str]],
               max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n with the standard brevity penalty and clipped
    n-gram precision (the coco-caption Bleu scorer's corpus formulation)."""
    p_num = [0] * max_n
    p_den = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        h = hyp.split()
        rs = [r.split() for r in refs]
        hyp_len += len(h)
        # closest reference length
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            hc = _ngram_counts(h, n)
            max_rc: Counter = Counter()
            for r in rs:
                rc = _ngram_counts(r, n)
                for g, c in rc.items():
                    max_rc[g] = max(max_rc[g], c)
            p_num[n - 1] += sum(min(c, max_rc[g]) for g, c in hc.items())
            p_den[n - 1] += max(sum(hc.values()), 0)
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    out = []
    log_acc = 0.0
    for n in range(max_n):
        p = p_num[n] / p_den[n] if p_den[n] > 0 else 0.0
        log_acc += math.log(max(p, 1e-12))
        out.append(bp * math.exp(log_acc / (n + 1)))
    return out


def evaluate_captions(
    predictions: Dict, ground_truth: Dict, include_spice: bool = False
) -> Dict[str, float]:
    """predictions: id -> [caption]; ground_truth: id -> [refs...].
    Returns {Bleu_1..4, ROUGE_L, CIDEr, (SPICE)}."""
    ids = sorted(ground_truth.keys())
    hyps = [predictions[i][0] for i in ids]
    refs = [ground_truth[i] for i in ids]

    bleu = bleu_score(hyps, refs)
    rouge_mean, _ = Rouge().compute_score(ground_truth, predictions)
    cider_mean, _ = CiderD().compute_score(ground_truth, predictions)
    out = {"Bleu_1": bleu[0], "Bleu_2": bleu[1], "Bleu_3": bleu[2], "Bleu_4": bleu[3]}
    try:
        out["METEOR"], _ = Meteor().compute_score(ground_truth, predictions)
    except ImportError as e:  # nltk absent: noted, as SPICE without its jars
        out["METEOR_skipped"] = str(e)
    out.update({"ROUGE_L": rouge_mean, "CIDEr": cider_mean})
    if include_spice:
        try:
            from aladin_torch.eval.spice import Spice

            out["SPICE"], _ = Spice().compute_score(ground_truth, predictions)
        except FileNotFoundError as e:
            out["SPICE_skipped"] = str(e)
    return out


def evaluate_caption_file(pred_file: str, gt_file: str) -> Dict[str, float]:
    """File-level API (the reference evaluates TSV/JSON prediction files
    against a COCO-format GT json)."""
    with open(pred_file) as f:
        preds_raw = json.load(f)
    with open(gt_file) as f:
        gt_raw = json.load(f)
    preds = {p["image_id"]: [p["caption"]] for p in preds_raw}
    gts: Dict = {}
    anns = gt_raw["annotations"] if isinstance(gt_raw, dict) else gt_raw
    for a in anns:
        gts.setdefault(a["image_id"], []).append(a["caption"])
    gts = {k: v for k, v in gts.items() if k in preds}
    return evaluate_captions(preds, gts)
