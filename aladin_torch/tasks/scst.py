"""Self-critical sequence training (SCST) for captioning (mirrors
aladin_tpu/tasks/scst.py).

Equivalent capability to ref:oscar/utils/caption_evaluate.py:115-197
(ScstRewardCriterion): sample captions, score them with CIDEr-D against the
ground-truth set, subtract the greedy-decode baseline reward, and weight the
sampled tokens' log-probabilities by the advantage:

    loss = - mean over sampled tokens( (r_sample - r_greedy) * logp )

The decoders (greedy, and sampling through top_k_top_p_filtering) come
from tasks/captioning.py and tasks/decode_cache.py; the reward is computed
on the host (a string metric, numpy as in aladin_tpu), the policy-gradient
loss on the device.

Data parallelism: SCST runs the whole batch on every rank, as aladin_tpu's
CLI feeds its unsharded inputs, with a sampling generator that is not
folded by rank, so every rank draws the same captions. The gradients are
averaged over the ranks all the same, so that the parameters stay equal
where the card's own sums are not repeatable (the embedding backward's
atomics).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from aladin_torch.eval.cider import CiderD
from aladin_torch.parallel.mesh import Mesh
from aladin_torch.tasks.captioning import BertImageCaptioner, token_logprobs
from aladin_torch.train.schedule import AdamW
from aladin_torch.train.step import average_gradients


class ScstRewardCriterion:
    def __init__(self, cider: CiderD | None = None, baseline_type: str = "greedy"):
        assert baseline_type in ("greedy", "sample_mean")
        self.cider = cider or CiderD()
        self.baseline_type = baseline_type

    def rewards(self, sampled: Sequence[str], greedy: Sequence[str],
                gt_sets: Sequence[List[str]]) -> np.ndarray:
        """(advantage per sample,) = CIDEr-D(sample) - baseline."""
        n, g = len(sampled), len(gt_sets)
        # samples are GROUPED per image (the reference's seq_per_img layout,
        # ref:caption_evaluate.py:137-146): sample i belongs to image
        # i // (n // g); greedy j is the one baseline decode of image j
        per = max(n // max(g, 1), 1)
        gts = {i: gt_sets[min(i // per, g - 1)] for i in range(n)}
        gts.update({n + j: gt_sets[j % max(g, 1)] for j in range(len(greedy))})
        res = {i: [s] for i, s in enumerate(list(sampled) + list(greedy))}
        _, scores = self.cider.compute_score(gts, res)
        sample_scores = scores[:n]
        if self.baseline_type == "greedy":
            base = scores[n:]
            if len(base) == 0:
                base = np.zeros(1)
            baseline = np.repeat(base, per)[:n]
            if len(baseline) < n:  # ragged n not divisible by g
                baseline = np.pad(baseline, (0, n - len(baseline)), mode="edge")
        else:
            baseline = np.full(n, sample_scores.mean())
        return sample_scores - baseline

    @staticmethod
    def loss(advantage: torch.Tensor, token_logprobs: torch.Tensor,
             token_mask: torch.Tensor) -> torch.Tensor:
        """- mean over REAL sampled tokens of advantage * logp
        (ref:caption_evaluate.py:190-196 semantics)."""
        weighted = -advantage[:, None] * token_logprobs * token_mask
        return weighted.sum() / token_mask.sum().clamp(min=1)


def make_scst_step(model: BertImageCaptioner, optimizer: AdamW, *, mask_id: int, pad_id: int,
                   mesh: Optional[Mesh] = None):
    """step(sampled token rows, advantage (B,), od_ids, od_seg, feats, mask)
    -> {"loss"} after one AdamW update on the SCST loss (token_logprobs in
    eval mode, no dropout, as aladin_tpu's deterministic pass)."""

    def step(sampled, advantage, od_ids, od_seg, feats, mask) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        lps, tmask = token_logprobs(model, sampled, od_ids, od_seg, feats, mask,
                                    mask_id=mask_id, pad_id=pad_id)
        loss = ScstRewardCriterion.loss(advantage, lps, tmask)
        loss.backward()
        if mesh is not None:
            average_gradients(mesh, [p.grad for p in optimizer.params if p.grad is not None])
        optimizer.step()
        return {"loss": loss.detach()}

    return step
