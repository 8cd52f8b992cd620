"""Offline captioning: the port's KV-cached greedy decoder,
``tasks/decode_cache.py::greedy_decode_cached``, as ``cli/captioning
--kv_cache`` runs it (f32, the kernel knobs off, max_seq_a_length - 1
steps), on batches of images one after another.

Set-up builds the captioner on the device with the benchmark's weights,
makes a pool of decode batches (``lib/inputs.py::caption_batches``) and
decodes the first batch once (warm-up, not counted). A unit decodes one
batch and copies its tokens and log-probabilities to the host.

The check, after the window: a sample of the captions served in the
window, drawn from the seed with the longest served caption in it, is run
through the plain full forward (``reference/caption.py``) at every served
position, over the program's own prefix. Two numbers:
  * ``token_gap``: the widest gap, over every served position, by which
    the served token's logit lies below the reference's best there (0
    where the program served the reference's greedy token);
  * ``logprob_gap``: the widest gap between a caption's summed
    log-probability as the program returned it and as the reference
    scores the same tokens.
"""

from __future__ import annotations

import torch

from h100_bench.lib import bounds, inputs
from h100_bench.lib import weights as W
from h100_bench.lib.trace import span
from h100_bench.lib.traffic import generator
from h100_bench.reference import caption as ref
from h100_bench.reference.precision import Precision


def port_config(c: dict):
    from aladin_torch.models.bert_img import BertImgConfig

    keys = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
            "intermediate_size", "hidden_act", "max_position_embeddings", "type_vocab_size",
            "layer_norm_eps", "initializer_range", "img_feature_dim", "fused_attention",
            "fused_layernorm")
    return BertImgConfig(**{k: c[k] for k in keys}, hidden_dropout_prob=c["residual_dropout"],
                         attention_probs_dropout_prob=c["attention_dropout"])


def served_lengths(tokens: torch.Tensor) -> torch.Tensor:
    """Tokens served a row: up to and including the first [SEP], else all
    the steps."""
    steps = tokens.shape[1] - 1
    is_sep = tokens[:, 1:] == inputs.SEP
    first = torch.where(is_sep.any(dim=1), is_sep.float().argmax(dim=1) + 1,
                        torch.full((tokens.shape[0],), steps))
    return first


class Captioning:
    def __init__(self, ctx):
        from aladin_torch.tasks import decode_cache
        from aladin_torch.tasks.captioning import BertImageCaptioner

        c, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.ctx, self.dc = ctx, decode_cache
        with torch.device(dev):
            model = BertImageCaptioner(port_config(c))
        model.load_state_dict(W.make(ref.spec(c), ctx.seed, inputs.S_WEIGHTS, dev,
                                     c["initializer_range"]), strict=True)
        self.model = model.eval()
        self.pool = inputs.caption_batches(c, tr, ctx.seed, dev, tr["pool_batches"])
        self.common = dict(max_steps=c["max_seq_a_length"] - 1, cls_id=inputs.CLS,
                           sep_id=inputs.SEP, mask_id=inputs.MASK, pad_id=inputs.PAD)
        self._decode(self.pool[0])
        self.served, self.next = [], 0

    def _decode(self, b):
        return self.dc.greedy_decode_cached(self.model, b["od_ids"], b["od_seg"], b["img_feats"],
                                            b["attn_mask"], **self.common)

    def unit(self) -> int:
        i = self.next % len(self.pool)
        with span("caption.batch"):
            tokens, logprob = self._decode(self.pool[i])
            tokens, logprob = tokens.cpu(), logprob.cpu()
        self.served.append((i, tokens, logprob))
        self.next += 1
        return tokens.shape[0]

    def drain(self) -> None:
        pass

    def counters(self) -> dict:
        c = self.ctx.config
        per_batch = []
        for b in self.pool:
            per_batch.append(bounds.caption_decode_flops(
                (b["od_len"] + b["img_len"]).tolist(), b["img_len"].tolist(),
                c["max_seq_a_length"] - 1, c["hidden_size"], c["num_hidden_layers"],
                c["intermediate_size"], c["vocab_size"], c["img_feature_dim"]))
        flops = sum(per_batch[i] for i, _, _ in self.served)
        return {"decode_flops": flops}

    def failed(self) -> int:
        bad = 0
        for _, tokens, logprob in self.served:
            bad += int((~torch.isfinite(logprob)).sum()) + int((tokens[:, 0] != inputs.CLS).sum())
        return bad

    def release(self) -> None:
        self.model = self.pool = None

    def sample(self):
        """[(batch index, row, tokens, log-prob)] of the captions the check
        reads: the longest served one, then a draw from the seed."""
        rows = [(i, r, t[r], lp[r]) for i, t, lp in self.served for r in range(t.shape[0])]
        n = min(self.ctx.traffic["check_captions"], len(rows))
        lens = torch.stack([served_lengths(t[None])[0] for _, _, t, _ in rows])
        longest = int(lens.argmax())
        perm = torch.randperm(len(rows), generator=generator(self.ctx.seed, inputs.S_SAMPLE))
        picked = [longest] + [int(j) for j in perm if int(j) != longest][:n - 1]
        return [rows[j] for j in picked]

    def check(self):
        return self._compare(None)

    def _compare(self, lower):
        """The check's numbers over the sample: of the program's served
        tokens and log-probabilities, or (``lower``, a control's precision)
        of the tokens that the reference in that precision puts first at
        the same positions and of its log-probabilities of the served
        tokens."""
        ctx, c = self.ctx, self.ctx.config
        pool = inputs.caption_batches(c, ctx.traffic, ctx.seed, ctx.device,
                                      ctx.traffic["pool_batches"])
        wts = W.make(ref.spec(c), ctx.seed, inputs.S_WEIGHTS, ctx.device, c["initializer_range"])
        token_gap = logprob_gap = 0.0
        for i, r, toks, lp in self.sample():
            b = {k: v[r:r + 1] for k, v in pool[i].items()}
            n = int(served_lengths(toks[None])[0])
            tokens = toks[None].to(ctx.device)
            served = toks[1:n + 1].to(ctx.device)[:, None]
            logits = ref.position_logits(wts, c, b, tokens, n, Precision("f32"))[0]
            if lower is None:
                first, got = served, float(lp)
            else:
                low = ref.position_logits(wts, c, b, tokens, n, Precision(lower))[0]
                first = low.argmax(dim=-1, keepdim=True)
                got = float(torch.log_softmax(low, dim=-1).gather(1, served).sum())
            want = float(torch.log_softmax(logits, dim=-1).gather(1, served).sum())
            below = logits.amax(dim=-1, keepdim=True) - logits.gather(1, first)
            token_gap = max(token_gap, float(below.max()))
            logprob_gap = max(logprob_gap, abs(want - got))
        limits = ctx.traffic["limits"]
        return [("token_gap", token_gap, limits["token_gap"]),
                ("logprob_gap", logprob_gap, limits["logprob_gap"])]


def control(work: Captioning) -> dict:
    """Readings of the control: the reference in TF32 scoring the same
    captions."""
    return {"tf32": work._compare("tf32")}


def setup(ctx) -> Captioning:
    return Captioning(ctx)
