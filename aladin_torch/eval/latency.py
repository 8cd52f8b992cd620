"""Serial per-query retrieval latency (mirrors aladin_tpu/eval/latency.py).

The reference's efficiency claim is per-query latency on a 1k-image COCO
fold: 0.023 s per query for the matching head (global dot products + sort)
and 0.098 s for the alignment head (full region-word scoring), on the
paper's GPU with its own implementation. They are quoted beside the
port's numbers as the paper's, not as a yardstick of another card.

Serial timing: K single-query searches run one after another in an eager
loop in which each query's input data-depends on the previous query's top
score (``q + carry * 0.0``), so no two queries overlap. The loop is timed
between ``torch.cuda.synchronize`` calls: the honest serial latency, host
launch time included. A measurement at or under zero returns ``None``.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from aladin_torch.eval.search import Corpus
from aladin_torch.ops.alignment import alignment_scores
from aladin_torch.ops.topk import top_k

#: per-query latency of the reference's two operating points (seconds,
#: 1k-image fold, the paper's GPU; ref:alad/plots/plot_efficiency_vs_effectiveness.py:13)
REF_MATCHING_S = 0.023
REF_ALIGNMENT_S = 0.098

MODES = ("matching", "two_stage", "full_alignment")


def make_serial_runner(mode: str, *, shortlist: int = 100, k: int = 10,
                       aggregation: str = "MrSw"):
    """``run(q_sets, q_lens, corpus) -> top indices (Q,)``: t2i caption
    queries against an image corpus, strictly one after another."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")

    @torch.inference_mode()
    def run(qs: torch.Tensor, ql: torch.Tensor, corpus: Corpus) -> torch.Tensor:
        kk = min(k, corpus.size)

        def matching(q, l):
            return top_k(q[0] @ corpus.globals.T, kk)

        def two_stage(q, l):
            _, short = top_k(q[0] @ corpus.globals.T, min(shortlist, corpus.size))
            a = alignment_scores(corpus.token_sets[short], q[None], corpus.lengths[short],
                                 l[None], aggregation, normalized=True)[:, 0]
            s, pos = top_k(a, min(kk, short.shape[0]))
            return s, short[pos]

        def full_alignment(q, l):
            a = alignment_scores(corpus.token_sets, q[None], corpus.lengths, l[None],
                                 aggregation, normalized=True)[:, 0]
            return top_k(a, kk)

        fn = {"matching": matching, "two_stage": two_stage,
              "full_alignment": full_alignment}[mode]
        carry = torch.zeros((), dtype=torch.float32, device=qs.device)
        tops = []
        for q, l in zip(qs, ql):
            # data-depend on the previous result so queries cannot overlap
            s, idx = fn(q + carry * 0.0, l)
            carry = s[0]
            tops.append(idx[0])
        return torch.stack(tops)

    return run


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serial_query_latency(corpus: Corpus, query_sets, query_lens, *, mode: str,
                         shortlist: int = 100, k: int = 10, aggregation: str = "MrSw",
                         n_serial: int = 64, repeats: int = 3) -> Tuple[Optional[float], str]:
    """Seconds per serial query (the best of ``repeats`` runs over
    ``n_serial`` queries, after one warm-up run), or ``(None, note)`` when
    the clock read no time at all."""
    device = corpus.device
    qs = torch.as_tensor(query_sets[:n_serial], dtype=torch.float32, device=device)
    ql = torch.as_tensor(query_lens[:n_serial], dtype=torch.int32, device=device)
    n = int(qs.shape[0])
    run = make_serial_runner(mode, shortlist=shortlist, k=k, aggregation=aggregation)
    run(qs, ql, corpus)
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(qs, ql, corpus)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    if best <= 0:
        return None, "below measurement floor (the clock read no time)"
    return best / n, ""
