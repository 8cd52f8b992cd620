"""Alignment-head evaluation: the scoring and ranking stage of
``eval/retrieval.py::evaluate_alignment_head`` on card-resident buffers:
``ops/kernels/alignment_kernel.py::mrsw_scores_bucketed`` (K1, bucketed by
caption length, in the configuration's score type), then
``eval/recall.py::compute_recall_from_scores``, which returns R@K and medr
to the host.

Set-up makes the token sets on the device (``lib/inputs.py::token_sets``)
and runs one unit (warm-up, not counted). A unit scores every (image,
caption) pair and ranks both directions.

The check, after the window, on the last unit's outputs:
  * ``score_err``: the largest gap between the program's scores and the
    plain float32 reference (``reference/mrsw.py``) over rows of sampled
    images and columns of sampled captions, drawn from the seed;
  * ``recall_err``: the largest gap between each R@K / medr the program
    returned and the reference's ranking of the program's own score matrix.
"""

from __future__ import annotations

import torch

from h100_bench.lib import bounds, inputs
from h100_bench.lib.trace import span
from h100_bench.lib.traffic import generator
from h100_bench.reference import mrsw as ref
from h100_bench.reference.precision import Precision

DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}


class Scoring:
    def __init__(self, ctx, score_dtype=None):
        from aladin_torch.eval import recall
        from aladin_torch.ops.kernels import alignment_kernel

        self.ctx, self.recall, self.ak = ctx, recall, alignment_kernel
        tr = ctx.traffic
        self.dtype = DTYPES[score_dtype or ctx.config["score_dtype"]]
        self.ims, self.caps, self.il, self.cl = inputs.token_sets(
            tr, ctx.seed, ctx.device, ctx.config["hidden_size"])
        self.per_image = tr["captions_per_image"]
        self.unit()

    def unit(self) -> int:
        with span("score.scores"):
            scores = self.ak.mrsw_scores_bucketed(self.ims, self.caps, self.il, self.cl,
                                                  compute_dtype=self.dtype)
        with span("score.ranks"):
            metrics = self.recall.compute_recall_from_scores(scores, self.per_image)
        self.last = (scores, metrics)
        return scores.shape[0] * scores.shape[1]

    def drain(self) -> None:
        pass

    def counters(self) -> dict:
        n_im, r, d = self.ims.shape
        n_cap, w, _ = self.caps.shape
        il, cl = self.il.tolist(), self.cl.tolist()
        return {"valid_ops_per_call": bounds.mrsw_valid_ops(d, il, cl),
                "k1_bound_s_per_call": bounds.mrsw_bound(n_im, r, n_cap, w, d, il, cl,
                                                         "int8" if self.dtype == torch.int8
                                                         else "bf16")[0]}

    def failed(self) -> int:
        scores, _ = self.last
        return int((~torch.isfinite(scores)).sum())

    def release(self) -> None:
        scores, metrics = self.last
        n = self.ctx.traffic["check_rows"]
        gen = generator(self.ctx.seed, inputs.S_SAMPLE)
        self.rows = torch.randperm(scores.shape[0], generator=gen)[:n]
        self.cols = torch.randperm(scores.shape[1], generator=gen)[:n]
        dev = scores.device
        self.out = {"rows": scores[self.rows.to(dev)].clone(),
                    "cols": scores[:, self.cols.to(dev)].clone(), "metrics": metrics,
                    "ranked": ref.recall(scores, self.per_image)}
        self.last = self.ims = self.caps = self.il = self.cl = None

    def check(self):
        return compare(self.ctx, self.out, self.rows, self.cols)


def control(work: Scoring) -> dict:
    """Readings of the control: the program's own int8 scoring path (K1
    int8, bucketed) on the same inputs, judged as the window's outputs are."""
    ctx = work.ctx
    ims, caps, il, cl = inputs.token_sets(ctx.traffic, ctx.seed, ctx.device,
                                          ctx.config["hidden_size"])
    scores = work.ak.mrsw_scores_bucketed(ims, caps, il, cl, compute_dtype=torch.int8)
    metrics = work.recall.compute_recall_from_scores(scores, work.per_image)
    dev = scores.device
    out = {"rows": scores[work.rows.to(dev)].clone(), "cols": scores[:, work.cols.to(dev)].clone(),
           "metrics": metrics, "ranked": ref.recall(scores, work.per_image)}
    del ims, caps, scores
    return {"int8": compare(ctx, out, work.rows, work.cols)}


def compare(ctx, out: dict, rows, cols):
    tr = ctx.traffic
    ims, caps, il, cl = inputs.token_sets(tr, ctx.seed, ctx.device, ctx.config["hidden_size"])
    dev = ims.device
    rows, cols = rows.to(dev), cols.to(dev)
    f32 = Precision("f32")
    want_rows = ref.scores(ims[rows], il[rows], caps, cl, f32)
    want_cols = ref.scores(ims, il, caps[cols], cl[cols], f32)
    err = max(float((out["rows"] - want_rows).abs().max()),
              float((out["cols"] - want_cols).abs().max()))
    recall_err = max(abs(out["metrics"][k] - v) for k, v in out["ranked"].items())
    lim = tr["limits"]
    return [("score_err", err, lim["score_err"]), ("recall_err", recall_err, lim["recall_err"])]


def setup(ctx) -> Scoring:
    return Scoring(ctx)
