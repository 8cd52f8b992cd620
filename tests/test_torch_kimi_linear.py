"""Kimi-Linear in the port (``models/kimi_linear.py``, ``ops/kernels/kda.py``'s
plain versions, ``ops/moe.py``'s held experts, ``tasks/decode_hybrid.py``)
against the benchmark's plain reference (``h100_bench/reference/
kimi_linear.py``) at a tiny size, in float32 on the CPU: hidden 64, KDA 4
heads of 16, MLA 4 heads (nope 16, rope 8, v 16, rank 32), layers K K K M
with layer 0 dense, 16 experts top-4 with 1 shared, vocabulary 97.

Both sides compute in float32 from the same weights and differ only in the
order of their sums (the recurrence token by token against the chunked
form, SDPA against an einsum, grouped GEMMs against an expert loop, the
absorbed product against the plain one): ~1e-5 on logits of magnitude ~5
at these sizes. The tolerances sit above that and far below what a wrong
decay, convolution tail, document boundary, expert or weight moves (0.01
and more).
"""

import dataclasses

import pytest
import torch

from aladin_torch.models import kimi_linear as KL
from aladin_torch.ops import moe
from aladin_torch.ops.kernels import kda
from aladin_torch.tasks import decode_cache, decode_hybrid
from aladin_torch.utils import profiling
from h100_bench.reference import kimi_linear as ref

TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_hidden_layers=4, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, num_experts=16, num_experts_per_token=4,
            num_shared_experts=1, first_k_dense_replace=1, kda_gate_rank=8, dtype="float32",
            linear_attn_config={"full_attn_layers": [4], "kda_layers": [1, 2, 3], "head_dim": 16,
                                "num_heads": 4, "short_conv_kernel_size": 4})
C = dataclasses.asdict(KL.KimiLinearConfig.from_dict(TINY))
ATOL = 1e-4  # float32 both sides, sums in another order: ~1e-5 observed
LENGTHS = (9, 3, 14, 6)  # ragged documents, one shorter than the convolutions' window


def tiny_weights(c=C, seed=0):
    """Names -> float32 tensors: matrices normal(0, 0.15), norm scales 1 +
    normal(0, 0.1), the correction bias normal(0, 0.1); the KDA decay's
    parameters spanning fast and slow channels, convolutions U(-1/2, 1/2)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in ref.spec(c):
        x = torch.randn(shape, generator=g)
        if name.endswith("A_log"):
            out[name] = torch.log(1 + 15 * torch.rand(shape, generator=g))
        elif name.endswith("dt_bias"):
            out[name] = -3 + 1.5 * x
        elif "_conv1d." in name:
            out[name] = torch.rand(shape, generator=g) - 0.5
        elif name.endswith("correction_bias"):
            out[name] = 0.1 * x
        elif len(shape) == 1:
            out[name] = 1.0 + 0.1 * x
        else:
            out[name] = 0.15 * x
    return out


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


@pytest.fixture(scope="module")
def model(weights):
    m = KL.KimiLinearForCausalLM(KL.KimiLinearConfig.from_dict(TINY)).eval()
    assert KL.load_named(m, weights.items()) == len(weights)
    return m


def documents(seed=1, lengths=LENGTHS):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 97, (sum(lengths),), generator=g)
    return ids, list(lengths), list(ids.split(list(lengths)))


def ref_logits(weights, seqs):
    return ref.logits(lambda names: {n: weights[n] for n in names}, C, seqs)


def test_layer_pattern_follows_the_published_lists():
    cfg = KL.KimiLinearConfig()
    mla = [i for i in range(27) if not cfg.is_kda(i)]
    assert mla == [3, 7, 11, 15, 19, 23, 26]
    assert [i + 1 for i in mla] == cfg.linear_attn_config["full_attn_layers"]


def test_kda_chunked_equals_kda_recurrent():
    """The chunked form (explicit pairwise decays, a triangular solve a
    chunk) and the token-by-token recurrence give the same outputs and final
    state, across chunk borders and a ragged last chunk, with decays from
    ~0 to ~-3 a token."""
    g = torch.Generator().manual_seed(5)
    b, t, h, d = 2, 150, 3, 16
    q = torch.nn.functional.normalize(torch.randn(b, t, h, d, generator=g), dim=-1) / 4
    k = torch.nn.functional.normalize(torch.randn(b, t, h, d, generator=g), dim=-1)
    v = torch.randn(b, t, h, d, generator=g)
    logd = -torch.exp(torch.empty(b, t, h, d).uniform_(-7, 1, generator=g))
    beta = torch.rand(b, t, h, generator=g)
    o1, s1 = ref.kda_recurrent(q, k, v, logd, beta)
    o2, s2 = ref.kda_chunked(q, k, v, logd, beta)
    torch.testing.assert_close(o2, o1, atol=1e-5, rtol=0)
    torch.testing.assert_close(s2, s1, atol=1e-5, rtol=0)


def test_kda_layer_matches_the_reference_on_packed_documents(model, weights):
    """Layer 0's KDA over four ragged documents packed end to end (the plain
    K5 path) equals the reference run on each document alone: outputs,
    final states and the convolutions' tails (each document's last 3 raw
    projections), so nothing leaks across a document border."""
    ids, lengths, seqs = documents()
    attn = model.layers[0].self_attn
    x = model.embed_tokens(ids)
    with torch.no_grad():
        h = model.layers[0].input_layernorm(x)
        state, tails = model.kda_buffers(len(lengths), "cpu")
        got = attn.prefill(h, KL.Pack.of(lengths, "cpu"), state[0], tails[0])
        hs = list(h.split(lengths))
        want, states = ref.kda_attention(weights, "model.layers.0.", C, hs, ref.Precision("f32"))
    torch.testing.assert_close(got, torch.cat(want), atol=1e-5, rtol=0)
    torch.testing.assert_close(state[0].transpose(-1, -2), states, atol=1e-5, rtol=0)
    for r, hd in enumerate(hs):
        raw = torch.cat([attn.q_proj(hd), attn.k_proj(hd), attn.v_proj(hd)], dim=1)
        last = torch.cat([raw.new_zeros(3, raw.shape[1]), raw])[-3:]
        torch.testing.assert_close(tails[0, r], last.detach(), atol=1e-6, rtol=0)


def test_full_forward_logits_match_the_reference(model, weights):
    ids, lengths, seqs = documents()
    with torch.no_grad():
        got = model(ids, lengths).split(lengths)
    for g_, w in zip(got, ref_logits(weights, seqs)):
        torch.testing.assert_close(g_, w, atol=ATOL, rtol=0)


def test_cached_decoding_equals_the_full_forward_at_every_served_position(model, weights):
    """The packed prefill and the cached steps (KDA states and tails carried
    by K6's plain path, the NoPE latent rows right-aligned) give the
    reference's full-forward logits at every served position; the greedy
    tokens and log-probabilities are those of each document decoded alone,
    so no state or tail leaks across packed documents."""
    steps = 6
    ids, lengths, seqs = documents()
    tokens, logprob = decode_cache.greedy_decode_cached(model, ids, lengths, max_steps=steps)
    assert tokens.shape == (4, steps)
    state = decode_hybrid.HybridState(model, 4, max(lengths), steps, "cpu")
    got = [decode_hybrid.prefill(model, ids, lengths, state)]
    for j in range(steps - 1):
        got.append(decode_hybrid.decode_step(model, state, tokens[:, j], j))
    got = torch.stack(got, dim=1)  # (B, steps, V)
    full = [torch.cat([s, t[:-1]]) for s, t in zip(seqs, tokens)]
    for b, (want, n) in enumerate(zip(ref_logits(weights, full), lengths)):
        want = want[n - 1:]
        torch.testing.assert_close(got[b], want, atol=ATOL, rtol=0)
        served = want.gather(1, tokens[b][:, None])[:, 0]
        assert (want.amax(dim=1) - served).max() < ATOL
    lp = torch.log_softmax(got, dim=-1).gather(2, tokens[..., None])[..., 0].sum(dim=1)
    torch.testing.assert_close(logprob, lp, atol=ATOL, rtol=0)
    for b, s in enumerate(seqs):
        alone, alone_lp = decode_cache.greedy_decode_cached(model, s, [len(s)], max_steps=steps)
        assert torch.equal(alone[0], tokens[b])
        torch.testing.assert_close(alone_lp[0], logprob[b], atol=ATOL, rtol=0)


def test_nope_mla_absorbed_equals_unabsorbed(model):
    """Layer 3's MLA without rotation: the last query through
    ``attend_absorbed`` over the latent rows equals the plain causal form's
    last row, and neither reads a rotation."""
    attn = model.layers[3].self_attn
    assert attn.cfg.mla_use_nope
    g = torch.Generator().manual_seed(3)
    s = 11
    h = torch.randn(1, s, TINY["hidden_size"], generator=g)
    with torch.no_grad():
        q_nope, q_pe = attn.queries(h, None)
        lat = attn.latent(h, None)
        plain = attn.attend(q_nope, q_pe, lat, None)[:, -1]
        absorbed = attn.attend_absorbed(q_nope[:, -1], q_pe[:, -1], lat, torch.zeros(1, 1, s))
        raw = attn.kv_a_proj_with_mqa(h)[..., -TINY["qk_rope_head_dim"]:]
    torch.testing.assert_close(absorbed, plain, atol=1e-5, rtol=0)
    torch.testing.assert_close(lat[..., -TINY["qk_rope_head_dim"]:], raw)


def test_held_expert_shares_add_up_to_the_uncut_layer(weights):
    """Four cards of 4 experts each (offsets 0, 4, 8, 12) over a 16-output
    router: each share's part, with the shared expert counted once, adds up
    to the uncut layer, in the program (``moe_forward`` with a held range)
    and in the reference; each pair is computed on exactly one card."""
    g = torch.Generator().manual_seed(4)
    t, hid, e, width, k = 37, 64, 16, 32, 4
    h = torch.randn(t, hid, generator=g)
    gw = 0.3 * torch.randn(e, hid, generator=g)
    bias = 0.1 * torch.randn(e, generator=g)
    gate_up = 0.2 * torch.randn(e, 2 * width, hid, generator=g)
    down = 0.2 * torch.randn(e, hid, width, generator=g)
    whole = moe.moe_forward(h, gw, bias, gate_up, down, top_k=k, scale=2.446)
    parts, pairs = 0, torch.zeros((), dtype=torch.int64)
    for first in range(0, e, 4):
        parts = parts + moe.moe_forward(h, gw, bias, gate_up[first:first + 4],
                                        down[first:first + 4], top_k=k, scale=2.446,
                                        first=first, pairs=pairs)
    torch.testing.assert_close(parts, whole, atol=1e-5, rtol=0)
    assert int(pairs) == t * k

    p = "model.layers.1."
    x = torch.randn(t, C["hidden_size"], generator=g)
    f32 = ref.Precision("f32")
    uncut = ref.moe(weights, p, C, x, f32)[0]
    shared = ref.swiglu(weights, p + "mlp.shared_experts.", x, f32)
    total = -3 * shared
    for first in range(0, 16, 4):
        total = total + ref.moe(weights, p, dict(C, num_experts=4, router_experts=16,
                                                 expert_offset=first), x, f32)[0]
    torch.testing.assert_close(total, uncut, atol=1e-5, rtol=0)


def test_a_held_share_model_equals_the_reference_share(weights):
    """A model holding experts 4-7 of 16 loads the published per-expert
    names of its share and equals the reference given the same share."""
    c = dict(C, num_experts=4, router_experts=16, expert_offset=4)
    w = {n: weights[n] for n, _ in ref.spec(c)}
    m = KL.KimiLinearForCausalLM(KL.KimiLinearConfig.from_dict(c)).eval()
    assert KL.load_named(m, w.items()) == len(w)
    assert m.layers[1].mlp.experts.gate_up_proj.shape[0] == 4
    ids, lengths, seqs = documents(seed=7)
    with torch.no_grad():
        got = m(ids, lengths).split(lengths)
    want = ref.logits(lambda names: {n: w[n] for n in names}, c, seqs)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=ATOL, rtol=0)


def test_plain_k6_equals_the_recurrence_after_the_prefill(model):
    """K6's plain path, step after step from the state and tails that K5's
    plain path left, equals the prefill run over the longer documents."""
    attn = model.layers[1].self_attn
    g = torch.Generator().manual_seed(8)
    lengths, extra = [5, 2, 7], 3
    h = torch.randn(sum(lengths) + extra * len(lengths), TINY["hidden_size"], generator=g)
    docs = list(h.split([n + extra for n in lengths]))
    with torch.no_grad():
        state, tails = model.kda_buffers(3, "cpu")
        longer = KL.Pack.of([n + extra for n in lengths], "cpu")
        want = attn.prefill(torch.cat(docs), longer, state[0], tails[0]).split(
            [n + extra for n in lengths])
        attn.prefill(torch.cat([d[:n] for d, n in zip(docs, lengths)]),
                     KL.Pack.of(lengths, "cpu"), state[1], tails[1])
        for j in range(extra):
            rows = torch.stack([d[n + j] for d, n in zip(docs, lengths)])
            got = attn.step(rows, state[1], tails[1])
            for r, n in enumerate(lengths):
                torch.testing.assert_close(got[r], want[r][n + j], atol=1e-5, rtol=0)
    torch.testing.assert_close(state[1], state[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(tails[1], tails[0])


def test_hybrid_decoder_spans_and_counters(model, tmp_path):
    """The packed prefill computes no pad token; each KDA layer runs the
    batch's tokens through the prefill kernel's path once; a step reads and
    writes every KDA state and tail; the held pairs are counted on the
    device; the spans are in a CPU profiler trace."""
    ids, lengths, _ = documents()
    steps = 4
    before = profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        decode_cache.greedy_decode_cached(model, ids, lengths, max_steps=steps)
    after = profiling.counters()
    diff = {n: after[n] - before[n] for n in after}
    assert diff["decode.prefill_pad_tokens"] == 0
    assert diff["kda.prefill_tokens"] == 3 * sum(lengths)
    st = decode_hybrid.held_state(model)
    per_step = 2 * (st.kda.numel() * 4 + st.tails.numel() * 4)
    assert diff["kda.state_bytes"] == (steps - 1) * per_step
    moe_layers = TINY["num_hidden_layers"] - 1
    assert diff["moe.held_pairs"] == moe_layers * 4 * (sum(lengths) + 4 * (steps - 1))
    assert 0 < diff["moe.experts_hit"] <= moe_layers * 16 * (steps - 1)
    names = {e.name for e in prof.events()}
    assert {"decode.cached", "decode.prefill", "decode.step", "kda.prefill"} <= names


def test_k5_k6_wrappers_take_the_plain_path_on_the_cpu():
    """On CPU tensors the kernel entries run their plain versions and count
    no launch."""
    g = torch.Generator().manual_seed(9)
    n, h, d = 7, 2, 16
    raw = [torch.randn(n, h * d, generator=g) for _ in range(4)]
    b = torch.randn(n, h, generator=g)
    w = kda.Weights(torch.rand(3, h * d, 4, generator=g) - 0.5, torch.zeros(h),
                    torch.full((h * d,), -2.0))
    state = torch.zeros(1, h, d, d)
    tails = torch.zeros(1, 3, 3 * h * d)
    before = profiling.counters()
    o = kda.kda_prefill(*raw, b, w, torch.tensor([0, n], dtype=torch.int32), torch.tensor([0]),
                        state, tails)
    kda.kda_step(*(x[:1] for x in raw), b[:1], w, state, tails)
    after = profiling.counters()
    assert o.shape == (n, h * d) and bool(torch.isfinite(o).all())
    assert after["k5.launches"] == before["k5.launches"]
    assert after["k6.launches"] == before["k6.launches"]
