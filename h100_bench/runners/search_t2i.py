"""Serial text-to-image search: ``eval/search.py::search`` with one caption
query at a time (direction t2i, the traffic's k and shortlist) over an
image corpus built by ``eval/search.py::build_corpus``, as ``cli/search
query`` answers a user.

Set-up makes the image token sets on the device, builds the corpus, keeps
the query pool (caption token sets) on the host, as queries arrive from a
client, and answers a few queries (warm-up, not counted). A unit hands one
query to ``search`` and ends when its top-k is on the host; the next query
goes out only then (a closed loop of one client). Queries follow a
permutation of the pool drawn from the seed.

The check, after the window, on a sample of the answered queries drawn
from the seed, against the plain two-stage reference
(``reference/search.py``, float32 over the corpus stored as configured):
  * ``rank_gap``: the widest gap by which the reference's score of the
    program's j-th answer lies below the reference's own j-th score;
  * ``score_gap``: the widest gap between a score the program returned and
    the reference's score of the same image.
A query whose answer is not k distinct corpus ids counts as failed.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.lib import inputs
from h100_bench.lib.trace import span
from h100_bench.lib.traffic import generator, permutation
from h100_bench.reference import search as ref
from h100_bench.reference.precision import Precision

STORE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Search:
    def __init__(self, ctx):
        from aladin_torch.eval import search

        self.ctx, self.search = ctx, search
        tr = ctx.traffic
        ims, caps, il, cl = inputs.token_sets(tr, ctx.seed, ctx.device, ctx.config["hidden_size"])
        self.corpus = search.build_corpus(ims, il, store_dtype=STORE[ctx.config["corpus_dtype"]],
                                          device=ctx.device)
        del ims
        self.queries, self.qlens = caps.cpu(), cl.cpu()
        del caps
        self.order = permutation(self.queries.shape[0], ctx.seed, inputs.S_ORDER)
        self.kw = dict(direction="t2i", k=tr["k"], shortlist=tr["shortlist"])
        for q in self.order[-tr["warmup_queries"]:]:
            self._ask(int(q))
        self.answers, self.next = [], 0

    def _ask(self, q: int):
        return self.search.search(self.corpus, self.queries[q:q + 1], self.qlens[q:q + 1],
                                  **self.kw)

    def unit(self) -> int:
        q = int(self.order[self.next % len(self.order)])
        with span("search.query"):
            scores, ids = self._ask(q)
        self.answers.append((q, scores[0], ids[0]))
        self.next += 1
        return 1

    def drain(self) -> None:
        pass

    def counters(self) -> dict:
        return {}

    def failed(self) -> int:
        k, n = self.ctx.traffic["k"], self.corpus.size
        bad = 0
        for _, scores, ids in self.answers:
            bad += not (len(ids) == k and len(set(ids.tolist())) == k
                        and bool(np.isfinite(scores).all()) and ids.min() >= 0 and ids.max() < n)
        return bad

    def release(self) -> None:
        self.corpus = self.queries = self.qlens = None

    def check(self):
        ctx, tr = self.ctx, self.ctx.traffic
        return compare(ctx, self.sample())

    def sample(self):
        gen = generator(self.ctx.seed, inputs.S_SAMPLE)
        picks = torch.randperm(len(self.answers), generator=gen)[:self.ctx.traffic["check_queries"]]
        return [self.answers[int(i)] for i in picks]


def control(work: Search) -> dict:
    """Readings of the control: the reference in the program's place with
    stage 1 in TF32 and the corpus's token sets stored in float8 e4m3,
    answering the same queries."""
    ctx, tr = work.ctx, work.ctx.traffic
    ims, caps, il, cl = inputs.token_sets(tr, ctx.seed, ctx.device, ctx.config["hidden_size"])
    c8 = ref.corpus(ims, il, "fp8")
    answers = []
    for q, _, _ in work.sample():
        s, i = ref.search(c8, caps[q], cl[q], tr["k"], tr["shortlist"], Precision("tf32"))
        answers.append((q, s.cpu().numpy(), i.cpu().numpy()))
    del ims, caps, c8
    return {"fp8_tf32": compare(ctx, answers)}


def compare(ctx, sample):
    """[(name, value, limit)]: ``sample`` holds (query index, scores, ids)
    answers; the reference searches with float32 stage 1 over the corpus
    stored as configured, and scores every answer."""
    tr = ctx.traffic
    ims, caps, il, cl = inputs.token_sets(tr, ctx.seed, ctx.device, ctx.config["hidden_size"])
    c = ref.corpus(ims, il, ctx.config["corpus_dtype"])
    rank_gap = score_gap = 0.0
    for q, scores, ids in sample:
        want, _ = ref.search(c, caps[q], cl[q], tr["k"], tr["shortlist"], Precision("f32"))
        got = ref.score(c, caps[q], cl[q], torch.as_tensor(ids, device=c["sets"].device).long())
        rank_gap = max(rank_gap, float((want - got).max()))
        score_gap = max(score_gap, float((torch.as_tensor(scores, device=got.device) - got)
                                         .abs().max()))
    lim = tr["limits"]
    return [("rank_gap", rank_gap, lim["rank_gap"]), ("score_gap", score_gap, lim["score_gap"])]


def setup(ctx) -> Search:
    return Search(ctx)
