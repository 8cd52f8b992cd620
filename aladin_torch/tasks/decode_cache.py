"""KV-cached caption decoding (mirrors aladin_tpu/tasks/decode_cache.py), the
reference's ``history_state`` capability
(ref:oscar/modeling/modeling_bert.py:23-147,659-755).

The full-recompute decoders in ``tasks/captioning.py`` run the whole
(caption + OD labels + regions) forward every step. This module gives the
prefill + incremental-step structure for serving, where the per-step cost
dominates:

  * OD-label and region tokens never attend to the caption (block mask,
    ref:oscar/run_captioning.py:297-317), so their per-layer K/V are
    computed ONCE (prefill) and reused by every decode step;
  * each step feeds exactly TWO tokens: the real token generated at
    position t-1 and the [MASK] probe at position t whose MLM logits emit
    token t, the reference's two-token past-decoding input
    (ref:oscar/modeling/modeling_bert.py:700-736).

The cache is one pair of head-major buffers, K and V of shape (layers, B,
H, C + S, Dh): slots [0, C) hold the context's K/V, written by the
prefill, and slot C + j caption position j. A step writes its real
token's K/V into caption slot t-1 (the previous step computed that
position from a [MASK] embedding) and the probe's into slot t, which the
next step overwrites, then attends over the buffers where they lie: a
(B, H, C + S, Dh) layer slice is what the batched matmuls read, so no key
is concatenated or copied. The buffers start at zero, never empty memory:
a masked slot still goes through the matmul, and a NaN there would turn
its whole row into NaN.

The step's additive bias over the C + S keys is built on the device from
``key_pos``, made once at prefill: the caption position a key's slot holds
(j for caption slot j, -1 for a valid context token, which every row
sees, and a position past any caption for an invalid one). Row r (the
token at position t - 1 + r) sees key j iff ``key_pos[j] <= t - 1 + r``:
prev sees the caption up to itself, the probe sees prev and itself. Masked
keys add exact zeros.

The layer math is the captioner's own: each step calls the backbone's
embedding (at explicit positions), projection, LayerNorm and FFN modules
and the plain attention core of ``BertSelfAttention.attend``, with the
same additive -10000 mask constant and f32 scores and softmax, so the
logits are those of the full-recompute path up to the order of the f32
sums. A step attends 2 queries over C + S keys, which is not the fused
attention kernel's contract (its query and key lengths are equal): it
stays plain torch, as it is plain XLA in aladin_tpu. ``quant_matmuls`` is
rejected at prefill.

Beam search gathers the caption slots by source beam each step; the
context slots are beam-invariant and never reordered.

``greedy_decode_cached`` is the one entry point of cached greedy
captioning, whatever the model: a model with a latent cache (Kimi-VL) goes
to ``tasks/decode_latent.py`` (imported at its first call), the BertImg
captioner to ``greedy_decode_bert``. A change to cached decoding made
behind this name reaches both models' callers.

Spans (``utils/profiling.py``): ``decode.cached`` around each decoder's
body, ``decode.prefill`` and ``decode.step``; ``decode.kv_bytes`` counts
the bytes of cached K and V each step's attention reads.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from aladin_torch.tasks.captioning import (BertImageCaptioner, beam_step, best_beam, categorical,
                                           initial_beam_scores, initial_caption,
                                           top_k_top_p_filtering)
from aladin_torch.utils import profiling

NEG_BIAS = -10000.0  # additive mask constant (ref:modeling_bert.py:226)


class DecodeCache(NamedTuple):
    k: torch.Tensor  # (layers, B, H, C + S, Dh): context slots [0, C), caption slot C + j
    v: torch.Tensor
    ctx_mask: torch.Tensor  # (B, C) 1 = valid context token
    key_pos: torch.Tensor  # (B, C + S) caption position each slot holds; -1: seen by every row


def _layer_tail(layer, x, ctx) -> torch.Tensor:
    """attention output -> LN(+res) -> FFN -> LN(+res), the layer's modules."""
    x = layer.attention.output(ctx, x)[0]
    return layer.output(layer.intermediate(x), x)[0]


@torch.no_grad()
def prefill(model: BertImageCaptioner, od_ids, od_seg, img_feats, attn_mask,
            max_seq_a: int) -> DecodeCache:
    """Run the OD-label + region context once, writing per-layer K/V into
    the context slots of zeroed buffers with ``max_seq_a`` caption slots
    (the model is put in eval mode).

    The context block is self-contained under the decode mask (labels and
    regions attend among themselves, never to the caption), so its K/V never
    change during decoding. ``attn_mask`` is the per-example (B, L, L) block
    mask the full-recompute decoders take; context validity is its diagonal
    over the positions >= max_seq_a."""
    with profiling.span("decode.prefill"):
        bert = model.bert
        cfg = bert.cfg
        if cfg.quant_matmuls:
            raise NotImplementedError(
                "decode_cache has no int8 path (decode is latency-bound, not "
                "GEMM-bound); run the cached decoders with a bf16/f32 config")
        model.eval()
        b, od_w = od_ids.shape
        ctx_mask = torch.diagonal(attn_mask[:, max_seq_a:, max_seq_a:], dim1=1, dim2=2).long()

        pos_ids = (max_seq_a + torch.arange(od_w, device=od_ids.device))[None, :]
        od = bert.embeddings(od_ids.long(), od_seg.long(), pos_ids)
        img = bert.img_embedding(img_feats.to(od.dtype))
        if cfg.use_img_layernorm:
            img = bert.LayerNorm(img)
        x = torch.cat([od, img], dim=1)  # (B, C, D)
        c = x.shape[1]

        heads = cfg.num_attention_heads
        k_buf = torch.zeros(len(bert.encoder.layer), b, heads, c + max_seq_a,
                            cfg.hidden_size // heads, dtype=x.dtype, device=x.device)
        v_buf = torch.zeros_like(k_buf)
        # every valid context token attends to every valid context token
        bias = ((1.0 - ctx_mask.float()) * NEG_BIAS)[:, None, None, :]  # (B, 1, 1, C)
        for i, layer in enumerate(bert.encoder.layer):
            sa = layer.attention.self
            q, k, v = sa.project(x)
            k_buf[i, :, :, :c] = k.transpose(1, 2)
            v_buf[i, :, :, :c] = v.transpose(1, 2)
            x = _layer_tail(layer, x, sa.attend(q, k, v, bias)[0])
        # an invalid context slot holds a position past every caption row
        ctx_pos = torch.where(ctx_mask.bool(), -1, max_seq_a)
        cap_pos = torch.arange(max_seq_a, device=x.device).expand(b, max_seq_a)
        return DecodeCache(k_buf, v_buf, ctx_mask, torch.cat([ctx_pos, cap_pos], dim=1))


@torch.no_grad()
def decode_step(model: BertImageCaptioner, cache: DecodeCache, prev_tok: torch.Tensor, t: int,
                *, mask_id: int) -> torch.Tensor:
    """One decode step at caption position ``t`` (the model in eval mode).

    Feeds [prev_tok @ t-1, MASK @ t] and writes their K/V into caption
    slots t-1 and t in place (the previous step computed slot t-1 from a
    [MASK] embedding; this step's probe slot is rewritten by the next one);
    the [MASK] probe's final hidden state gives the MLM logits of position
    t. Returns the (B, V) f32 logits."""
    with profiling.span("decode.step"):
        bert = model.bert
        b = prev_tok.shape[0]
        c = cache.ctx_mask.shape[1]
        dev = prev_tok.device
        ids = torch.full((b, 2), mask_id, dtype=torch.long, device=dev)
        ids[:, 0] = prev_tok
        pos_ids = torch.arange(t - 1, t + 1, device=dev)[None, :]
        x = bert.embeddings(ids, torch.zeros_like(ids), pos_ids)  # (B, 2, D)

        # row r, the token at position t - 1 + r, sees key j iff key_pos[j] <= t - 1 + r
        bias = torch.where(cache.key_pos[:, None, None, :] <= pos_ids[..., None], 0.0,
                           NEG_BIAS)  # (B, 1, 2, C + S)
        profiling.count("decode.kv_bytes", 2 * cache.k.numel() * cache.k.element_size())

        slots = slice(c + t - 1, c + t + 1)
        for i, layer in enumerate(bert.encoder.layer):
            sa = layer.attention.self
            q, k, v = sa.project(x)
            cache.k[i, :, :, slots] = k.transpose(1, 2)
            cache.v[i, :, :, slots] = v.transpose(1, 2)
            ctx = sa.attend(q, cache.k[i].transpose(1, 2), cache.v[i].transpose(1, 2), bias)[0]
            x = _layer_tail(layer, x, ctx)
        return model.head(x[:, 1])  # the MASK probe -> (B, V)


def greedy_decode_cached(model, *inputs, **options) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached greedy decode by the model's kind of cache: a model with a
    latent cache (``latent_cache``, Kimi-VL's language model) goes to
    ``tasks/decode_latent.py::greedy_decode`` (input_ids, image_embeds,
    attention_mask; max_steps), the BertImg captioner to
    ``greedy_decode_bert``."""
    if getattr(model, "latent_cache", False):
        from aladin_torch.tasks import decode_latent

        return decode_latent.greedy_decode(model, *inputs, **options)
    return greedy_decode_bert(model, *inputs, **options)


@torch.no_grad()
def greedy_decode_bert(model: BertImageCaptioner, od_ids, od_seg, img_feats, attn_mask, *,
                       max_steps: int, cls_id: int, sep_id: int, mask_id: int, pad_id: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached greedy decode: the outputs of tasks.captioning.greedy_decode
    (tokens (B, max_steps + 1), summed log-probs)."""
    with profiling.span("decode.cached"):
        b, s = img_feats.shape[0], max_steps + 1
        cache = prefill(model, od_ids, od_seg, img_feats, attn_mask, s)
        cap = initial_caption(b, s, cls_id, mask_id, img_feats.device)
        finished = torch.zeros(b, dtype=torch.bool, device=cap.device)
        logprob = torch.zeros(b, device=cap.device)
        prev = cap[:, 0].clone()
        for t in range(1, s):
            logp = F.log_softmax(decode_step(model, cache, prev, t, mask_id=mask_id), dim=-1)
            tok = logp.argmax(dim=-1)
            tok_lp = logp.gather(1, tok[:, None])[:, 0]
            tok = torch.where(finished, pad_id, tok)
            logprob += torch.where(finished, 0.0, tok_lp)
            cap[:, t] = tok
            finished |= tok == sep_id
            prev = tok
        return cap, logprob


@torch.no_grad()
def sample_decode_cached(model: BertImageCaptioner, od_ids, od_seg, img_feats, attn_mask,
                         generator: torch.Generator, *, max_steps: int, cls_id: int,
                         sep_id: int, mask_id: int, pad_id: int, top_k: int = 0,
                         top_p: float = 1.0, temperature: float = 1.0) -> torch.Tensor:
    """KV-cached stochastic decode: the same draws from ``generator`` (one
    uniform row a step) as tasks.captioning.sample_decode, so the same
    generator state and the same logits give the same caption. Returns
    token rows (B, max_steps + 1)."""
    with profiling.span("decode.cached"):
        b, s = img_feats.shape[0], max_steps + 1
        cache = prefill(model, od_ids, od_seg, img_feats, attn_mask, s)
        cap = initial_caption(b, s, cls_id, mask_id, img_feats.device)
        finished = torch.zeros(b, dtype=torch.bool, device=cap.device)
        prev = cap[:, 0].clone()
        for t in range(1, s):
            logits = decode_step(model, cache, prev, t, mask_id=mask_id)
            logits = top_k_top_p_filtering(logits / temperature, top_k, top_p)
            tok = torch.where(finished, pad_id, categorical(logits, generator))
            cap[:, t] = tok
            finished |= tok == sep_id
            prev = tok
        return cap


@torch.no_grad()
def beam_search_decode_cached(model: BertImageCaptioner, od_ids, od_seg, img_feats, attn_mask,
                              *, max_steps: int, num_beams: int = 5, cls_id: int, sep_id: int,
                              mask_id: int, pad_id: int, length_penalty: float = 1.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached fixed-width beam search: the outputs of
    tasks.captioning.beam_search_decode. The prefill runs on the B
    originals (the context is beam-invariant) and its K/V are repeated
    across the beams."""
    with profiling.span("decode.cached"):
        b, k, s = img_feats.shape[0], num_beams, max_steps + 1
        c = prefill(model, od_ids, od_seg, img_feats, attn_mask, s)
        cache = DecodeCache(c.k.repeat_interleave(k, dim=1), c.v.repeat_interleave(k, dim=1),
                            c.ctx_mask.repeat_interleave(k, dim=0),
                            c.key_pos.repeat_interleave(k, dim=0))
        cap = initial_caption(b * k, s, cls_id, mask_id, img_feats.device)
        scores = initial_beam_scores(b, k, cap.device)
        finished = torch.zeros(b * k, dtype=torch.bool, device=cap.device)
        lengths = torch.ones(b * k, dtype=torch.long, device=cap.device)
        prev = cap[:, 0].clone()
        for t in range(1, s):
            logp = F.log_softmax(decode_step(model, cache, prev, t, mask_id=mask_id), dim=-1)
            top_scores, rows, tok = beam_step(scores, logp, finished, b, k, pad_id)
            cap, finished, lengths = cap[rows], finished[rows], lengths[rows]
            reorder_caption_slots(cache, rows)
            prev = torch.where(finished, pad_id, tok)
            cap[:, t] = prev
            lengths = torch.where(finished, lengths, lengths + 1)
            finished = finished | (tok == sep_id)
            scores = top_scores.reshape(-1)
        return best_beam(cap, scores, lengths, b, k, length_penalty)


def reorder_caption_slots(cache: DecodeCache, rows: torch.Tensor) -> None:
    """Gather every layer's caption slots by source beam ``rows``, in place;
    the context slots are beam-invariant and stay."""
    cap = slice(cache.ctx_mask.shape[1], None)
    cache.k[:, :, :, cap] = cache.k[:, rows, :, cap]
    cache.v[:, :, :, cap] = cache.v[:, rows, :, cap]
