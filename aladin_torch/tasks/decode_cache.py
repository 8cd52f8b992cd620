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

``CachedSteps`` is the cache as a step source: the decoding policies of
``tasks/captioning.py`` (greedy, sampling, beam search) run over it as
they run over the full recompute. ``greedy_decode_cached`` is the one
entry point of cached greedy captioning, whatever the model: a model with
a latent cache (Kimi-VL) goes to ``tasks/decode_latent.py``, one with a
hybrid cache (Kimi-Linear) to ``tasks/decode_hybrid.py`` (each imported at
its first call), the BertImg captioner to the greedy policy over
``CachedSteps``. A change to cached decoding made behind this name reaches
every model's callers.

Spans (``utils/profiling.py``): ``decode.cached`` around each cached
decode, ``decode.prefill`` and ``decode.step``; ``decode.kv_bytes`` counts
the bytes of cached K and V each step's attention reads.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

# initial_caption stays a name of this module: h100_bench's caption faults
# build their captions with it
from aladin_torch.tasks.captioning import (BertImageCaptioner, greedy_decode,  # noqa: F401
                                           initial_caption)
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


class CachedSteps:
    """The KV-cache step source of the decoding policies in
    ``tasks/captioning.py`` (see ``StepInputs`` for the protocol): prefills
    at construction, then runs ``decode_step`` once a step on ``prev``,
    looked up in this module at each call. With ``beams`` > 1 the prefill
    runs on the B originals (the context is beam-invariant) and its K/V are
    repeated across the beams; ``reorder`` is ``reorder_caption_slots``. A
    decode over it is one ``decode.cached`` span."""

    span = functools.partial(profiling.span, "decode.cached")

    def __init__(self, model: BertImageCaptioner, od_ids, od_seg, img_feats, attn_mask,
                 max_seq_a: int, *, mask_id: int, beams: int = 1):
        cache = prefill(model, od_ids, od_seg, img_feats, attn_mask, max_seq_a)
        if beams > 1:
            cache = DecodeCache(cache.k.repeat_interleave(beams, dim=1),
                                cache.v.repeat_interleave(beams, dim=1),
                                cache.ctx_mask.repeat_interleave(beams, dim=0),
                                cache.key_pos.repeat_interleave(beams, dim=0))
        self.model, self.cache, self.mask_id = model, cache, mask_id

    def logits(self, cap: torch.Tensor, t: int, prev: torch.Tensor) -> torch.Tensor:
        return decode_step(self.model, self.cache, prev, t, mask_id=self.mask_id)

    def reorder(self, rows: torch.Tensor) -> None:
        reorder_caption_slots(self.cache, rows)


def greedy_decode_cached(model, *inputs, **options) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached greedy decode by the model's kind of cache: a model with a
    latent cache (``latent_cache``, Kimi-VL's language model) goes to
    ``tasks/decode_latent.py::greedy_decode`` (input_ids, image_embeds,
    attention_mask; max_steps), one with a hybrid cache (``hybrid_cache``,
    Kimi-Linear) to ``tasks/decode_hybrid.py::greedy_decode`` (packed
    input_ids, lengths; max_steps), the BertImg captioner to
    ``tasks/captioning.py::greedy_decode`` over ``CachedSteps`` (the inputs
    and outputs of that decoder)."""
    if getattr(model, "latent_cache", False):
        from aladin_torch.tasks import decode_latent

        return decode_latent.greedy_decode(model, *inputs, **options)
    if getattr(model, "hybrid_cache", False):
        from aladin_torch.tasks import decode_hybrid

        return decode_hybrid.greedy_decode(model, *inputs, **options)
    return greedy_decode(CachedSteps, model, *inputs, **options)


def reorder_caption_slots(cache: DecodeCache, rows: torch.Tensor) -> None:
    """Gather every layer's caption slots by source beam ``rows``, in place;
    the context slots are beam-invariant and stay."""
    cap = slice(cache.ctx_mask.shape[1], None)
    cache.k[:, :, :, cap] = cache.k[:, rows, :, cap]
    cache.v[:, :, :, cap] = cache.v[:, rows, :, cap]
