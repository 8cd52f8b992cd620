"""A run with the timed path broken underneath comes out not correct:
each fault the cell can have, planted in the program at the tiny CPU size
(one process: no exchange between chips to leave out)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from h100_bench.tests import tiny


def state_unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def train_half_batch(mp):
    from aladin_torch.models.aladin import Batch
    from aladin_torch.train import step as S

    orig = S.make_loss_fn

    def half(model, cfg, compute_dtype=None, mesh=None):
        fn = orig(model, cfg, compute_dtype, mesh)

        def loss(aux, batch, epoch, distill_gate=None):
            n = batch.txt_ids.shape[0] // 2
            kept = Batch(**{f.name: getattr(batch, f.name)[:n] for f in dataclasses.fields(Batch)})
            return fn(aux, kept, epoch, distill_gate)

        return loss

    mp.setattr(S, "make_loss_fn", half)


def caption_token_altered(mp):
    from aladin_torch.tasks import decode_cache

    orig = decode_cache.decode_step

    def step(model, cache, prev_tok, t, *, mask_id):
        logits = orig(model, cache, prev_tok, t, mask_id=mask_id)
        logits[:, :] = logits.roll(1, dims=-1)  # every row's best moves to the next id
        return logits

    mp.setattr(decode_cache, "decode_step", step)


def train_dropout_off(mp):
    mp.setattr(torch.nn.Dropout, "forward", lambda self, x: x)


def caption_second_best(mp):
    """Serve each step's second-best token, reporting its true
    log-probability."""
    import torch.nn.functional as F

    from aladin_torch.tasks import decode_cache as dc

    def decode(model, od_ids, od_seg, img_feats, attn_mask, *, max_steps, cls_id, sep_id,
               mask_id, pad_id):
        b, s = img_feats.shape[0], max_steps + 1
        cache = dc.prefill(model, od_ids, od_seg, img_feats, attn_mask, s)
        cap = dc.initial_caption(b, s, cls_id, mask_id, img_feats.device)
        finished = torch.zeros(b, dtype=torch.bool)
        logprob = torch.zeros(b)
        prev = cap[:, 0].clone()
        for t in range(1, s):
            logp = F.log_softmax(dc.decode_step(model, cache, prev, t, mask_id=mask_id), dim=-1)
            tok = logp.topk(2, dim=-1).indices[:, 1]
            tok_lp = logp.gather(1, tok[:, None])[:, 0]
            tok = torch.where(finished, pad_id, tok)
            logprob += torch.where(finished, 0.0, tok_lp)
            cap[:, t] = tok
            finished |= tok == sep_id
            prev = tok
        return cap, logprob

    mp.setattr(dc, "greedy_decode_cached", torch.no_grad()(decode))


def caption_half_batch(mp):
    from aladin_torch.tasks import decode_cache

    orig = decode_cache.greedy_decode_cached

    def decode(model, od_ids, od_seg, img_feats, attn_mask, **kw):
        n = od_ids.shape[0] // 2
        cap, lp = orig(model, od_ids[:n], od_seg[:n], img_feats[:n], attn_mask[:n], **kw)
        rest = torch.full((od_ids.shape[0] - n, cap.shape[1]), kw["mask_id"], dtype=cap.dtype)
        rest[:, 0] = kw["cls_id"]
        return torch.cat([cap, rest]), torch.cat([lp, torch.zeros(od_ids.shape[0] - n)])

    mp.setattr(decode_cache, "greedy_decode_cached", decode)


def score_altered(mp):
    from aladin_torch.ops.kernels import alignment_kernel as ak

    orig = ak.mrsw_scores_bucketed

    def scores(*a, **kw):
        s = orig(*a, **kw)
        s[:, ::2] += 0.05
        return s

    mp.setattr(ak, "mrsw_scores_bucketed", scores)


def score_half_batch(mp):
    from aladin_torch.ops.kernels import alignment_kernel as ak

    orig = ak.mrsw_scores_bucketed

    def scores(im, caps, il, cl, **kw):
        n = caps.shape[0] // 2
        s = orig(im, caps[:n], il, cl[:n], **kw)
        return torch.cat([s, torch.zeros(s.shape[0], caps.shape[0] - n)], dim=1)

    mp.setattr(ak, "mrsw_scores_bucketed", scores)


def search_answer_altered(mp):
    from aladin_torch.eval import search

    orig = search.search

    def ask(corpus, *a, **kw):
        scores, ids = orig(corpus, *a, **kw)
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + corpus.size // 2) % corpus.size
        return scores, ids

    mp.setattr(search, "search", ask)


FAULTS = {
    "aladin.train_bs32": [state_unchanged, train_half_batch, train_dropout_off],
    "caption.greedy_kv512": [caption_token_altered, caption_second_best, caption_half_batch],
    "aladin.score_5k": [score_altered, score_half_batch],
    "aladin.t2i_search": [search_answer_altered],
}
CASES = [(cell, f) for cell, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = tiny.run(cell)
    assert not line["correct"], line["checks"]
    assert any(not (np.isfinite(c["value"]) and c["value"] <= c["limit"])
               for c in line["checks"].values()) or line["failed"] > 0
