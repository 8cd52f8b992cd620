"""Plain PyTorch two-stage text-to-image search (ALADIN's retrieve and
rerank): stage 1 ranks the corpus by the inner product of l2-normalised
global embeddings (slot 0 of each token set) and keeps a shortlist; stage
2 scores the shortlist with MrSw (``reference/mrsw.py``) and keeps the
top k. Ties go to the lower index. The corpus's token sets are stored in
the configuration's type (normalised in float32 first) and scored in
float32."""

from __future__ import annotations

from typing import Dict

import torch

from h100_bench.reference import mrsw
from h100_bench.reference.precision import E4M3_MAX, Precision, scaled_round

STORE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def corpus(sets: torch.Tensor, lens: torch.Tensor, store: str) -> Dict[str, torch.Tensor]:
    """The indexed corpus: globals (N, D) f32, token sets rounded to
    ``store`` ("bfloat16", "float32", or "fp8" with one e4m3 scale)."""
    x = sets.float()
    x = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    if store == "fp8":
        x = scaled_round(x, torch.float8_e4m3fn, E4M3_MAX)
    else:
        x = x.to(STORE[store]).float()
    g = sets[:, 0].float()
    return {"sets": x, "globals": g / g.norm(dim=-1, keepdim=True).clamp(min=1e-12), "lens": lens}


def stable_top(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest, the lower index first on ties."""
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    return scores[order], order


@torch.no_grad()
def score(c: Dict[str, torch.Tensor], query: torch.Tensor, qlen: torch.Tensor,
          ids: torch.Tensor) -> torch.Tensor:
    """MrSw of one caption query (W, D) against corpus images ``ids``, f32."""
    return mrsw.scores(c["sets"][ids], c["lens"][ids], query[None], qlen[None],
                       Precision("f32"), images_normalized=True)[:, 0]


@torch.no_grad()
def search(c: Dict[str, torch.Tensor], query: torch.Tensor, qlen: torch.Tensor, k: int,
           shortlist: int, stage1: Precision):
    """(top-k scores, top-k corpus ids) of one caption query (W, D), its
    global embedding at slot 0."""
    q = query[0].float()
    q = q / q.norm().clamp(min=1e-12)
    with stage1.context():
        sims = stage1.matmul(c["globals"], q[:, None])[:, 0]
    _, short = stable_top(sims, min(shortlist, sims.shape[0]))
    s = score(c, query, qlen, short)
    best, pos = stable_top(s, min(k, s.shape[0]))
    return best, short[pos]
