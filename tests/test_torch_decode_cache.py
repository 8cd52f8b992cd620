"""KV-cached caption decoding in aladin_torch (tasks/decode_cache.py): the
prefill + two-token-step decoders give the tokens of the port's
full-recompute decoders across the config-variant matrix of
tests/test_decode_cache.py, and the tokens of aladin_tpu's cached
decoders, with per-example OD / region lengths (the cache's context
validity mask).

Weights come from aladin_tpu's Flax parameters through
``io/convert.py::task_state_dict_from_flax`` (tests/test_torch_captioning.py
builds both captioners). Tolerances: tokens equal; summed log-probs and
beam scores within 1e-5 (the cached step sums its f32 attention over
another key set than the full forward, whose masked keys add exact zeros).
"""

import numpy as np
import pytest
import torch

from aladin_tpu.tasks import decode_cache as jdc
from aladin_torch.models.bert_img import BertImgConfig
from aladin_torch.tasks import captioning as cap
from aladin_torch.tasks import decode_cache as dc
from tests.test_torch_captioning import (ATOL, B, IMG_W, KW, MAX_SEQ_A, OD_W, _close, _t,
                                         captioner_pair, decode_case,
                                         one_torch_thread)  # noqa: F401 (autouse)

VARIANTS = [(), (("use_img_layernorm", False),), (("num_attention_heads", 2),),
            (("num_attention_heads", 8),), (("remat", True),),
            (("hidden_size", 48), ("intermediate_size", 96), ("num_attention_heads", 6)),
            (("hidden_act", "gelu_tanh"),)]


@pytest.mark.parametrize("variant", VARIANTS,
                         ids=["base", "no_img_ln", "heads2", "heads8", "remat", "width48",
                              "gelu_tanh"])
def test_cached_greedy_equals_full_recompute_across_variants(variant):
    """The config-variant fence: the cached step reads the backbone's own
    modules, so it tracks every knob that changes the forward math; tokens
    equal and log-probs within 1e-5 of the full-recompute decoder."""
    _, _, tm = captioner_pair(variant)
    inp = _t(*decode_case())
    full_toks, full_lp = cap.greedy_decode(cap.StepInputs, tm, *inp, **KW)
    toks, lp = dc.greedy_decode_cached(tm, *inp, **KW)
    np.testing.assert_array_equal(toks.numpy(), full_toks.numpy())
    _close(lp, full_lp)


def test_prefill_shapes_and_context_validity():
    """The head-major buffers: context slots hold aladin_tpu's prefill K/V,
    the caption slots start at zero."""
    jm, params, tm = captioner_pair()
    inp = decode_case()
    cache = dc.prefill(tm, *_t(*inp), MAX_SEQ_A)
    cfg = tm.bert.cfg
    h, dh, c = cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads, OD_W + IMG_W
    assert cache.k.shape == cache.v.shape == (cfg.num_hidden_layers, B, h, c + MAX_SEQ_A, dh)
    want = jdc.prefill(params, jm.cfg, *inp, MAX_SEQ_A)
    for got, ref in ((cache.k, want.ctx_k), (cache.v, want.ctx_v)):
        _close(got[:, :, :, :c], np.asarray(ref).transpose(0, 1, 3, 2, 4))
        assert not got[:, :, :, c:].any()
    np.testing.assert_array_equal(cache.ctx_mask.numpy(), [[1] * 5 + [1] * 4,
                                                           [1, 1, 1, 0, 0] + [1, 1, 0, 0],
                                                           [1, 1, 0, 0, 0] + [1, 1, 1, 0]])


def test_decode_step_reads_the_cache_in_place():
    """A step concatenates nothing and copies no tensor as wide as the
    cache's C + S keys: the batched matmuls read the buffers where they lie."""
    _, _, tm = captioner_pair()
    cache = dc.prefill(tm, *_t(*decode_case()), MAX_SEQ_A)
    keys = cache.k.shape[3]
    prev = torch.full((B,), KW["cls_id"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        dc.decode_step(tm, cache, prev, 3, mask_id=KW["mask_id"])
    ops = [(e.name, e.input_shapes) for e in prof.events()]
    assert ("aten::bmm" in {n for n, _ in ops}) and not any(n == "aten::cat" for n, _ in ops)
    # (B, H, keys, Dh) or its transpose: the attention's K / V operands
    wide = [(n, sh) for n, sh in ops if n in ("aten::clone", "aten::copy_")
            and any(len(x) == 4 and max(x[2:]) >= keys for x in sh)]
    assert not wide, wide


def test_beam_reorder_moves_caption_slots_only():
    """The beam reorder gathers the caption slots by source beam in place;
    the context slots stay as the prefill wrote them."""
    _, _, tm = captioner_pair()
    cache = dc.prefill(tm, *_t(*decode_case()), MAX_SEQ_A)
    c = OD_W + IMG_W
    gen = torch.Generator().manual_seed(1)
    cache.k[:, :, :, c:] = torch.randn(cache.k[:, :, :, c:].shape, generator=gen)
    cache.v[:, :, :, c:] = torch.randn(cache.v[:, :, :, c:].shape, generator=gen)
    before = cache.k.clone(), cache.v.clone()
    rows = torch.tensor([2, 0, 0])
    dc.reorder_caption_slots(cache, rows)
    for got, was in zip((cache.k, cache.v), before):
        assert torch.equal(got[:, :, :, :c], was[:, :, :, :c])
        assert torch.equal(got[:, :, :, c:], was[:, rows, :, c:])


@pytest.mark.parametrize("mode", ["greedy", "beam1", "beam3", "beam5"])
def test_cached_decoders_match_jax_and_full(mode):
    """Cached greedy and beam (1, 3, 5): tokens equal to aladin_tpu's cached
    decoders and to the port's full-recompute ones; scores within 1e-5."""
    jm, params, tm = captioner_pair()
    inp = decode_case()
    jcfg = jm.cfg
    if mode == "greedy":
        got = dc.greedy_decode_cached(tm, *_t(*inp), **KW)
        full = cap.greedy_decode(cap.StepInputs, tm, *_t(*inp), **KW)
        want = jdc.greedy_decode_cached(params, *inp, cfg=jcfg, **KW)
    else:
        k = int(mode[-1])
        got = cap.beam_search_decode(dc.CachedSteps, tm, *_t(*inp), num_beams=k, **KW)
        full = cap.beam_search_decode(cap.StepInputs, tm, *_t(*inp), num_beams=k, **KW)
        want = jdc.beam_search_decode_cached(params, *inp, cfg=jcfg, num_beams=k, **KW)
    for ref in (full, want):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        _close(got[1], ref[1], atol=ATOL)


def test_cached_sampling_equals_full_recompute_sampling():
    """The same generator state and the same logits draw the same caption,
    with and without a top-k filter, and under a top-p filter at a
    temperature."""
    _, _, tm = captioner_pair()
    inp = _t(*decode_case())
    for opts in (dict(top_k=0), dict(top_k=4), dict(top_p=0.9, temperature=0.7)):
        full, cached = (cap.sample_decode(steps, tm, *inp, torch.Generator().manual_seed(3),
                                          **opts, **KW)
                        for steps in (cap.StepInputs, dc.CachedSteps))
        np.testing.assert_array_equal(cached.numpy(), full.numpy())


def test_cached_step_logits_equal_full_forward_rows():
    """decode_step's logits at every position t of a fixed caption equal
    the full forward's row t within 1e-5 (the cache written slot by slot)."""
    _, _, tm = captioner_pair()
    od_ids, od_seg, feats, masks = _t(*decode_case())
    rows = torch.from_numpy(np.random.RandomState(4).randint(5, 21, (B, MAX_SEQ_A)))
    rows[:, 0] = KW["cls_id"]
    cache = dc.prefill(tm, od_ids, od_seg, feats, masks, MAX_SEQ_A)
    seg = torch.cat([torch.zeros(B, MAX_SEQ_A, dtype=torch.int32), od_seg], 1)
    for t in range(1, MAX_SEQ_A):
        got = dc.decode_step(tm, cache, rows[:, t - 1], t, mask_id=KW["mask_id"])
        cap_t = torch.where(torch.arange(MAX_SEQ_A) < t, rows, KW["mask_id"])
        with torch.no_grad():
            want = tm(torch.cat([cap_t, od_ids.long()], 1), masks, seg, feats, positions=t)
        _close(got, want)


def test_quant_matmuls_rejected_at_prefill():
    tm = cap.BertImageCaptioner(BertImgConfig(vocab_size=21, hidden_size=32, num_hidden_layers=1,
                                              num_attention_heads=4, intermediate_size=64,
                                              img_feature_dim=12, quant_matmuls=True))
    with pytest.raises(NotImplementedError, match="int8"):
        dc.prefill(tm, *_t(*decode_case()), MAX_SEQ_A)
