"""Kimi-VL's language model in the port (``models/kimi_vl.py``,
``ops/moe.py``, ``tasks/decode_latent.py``) against the benchmark's plain
reference (``h100_bench/reference/kimi_vl.py``) at a tiny size, in
float32 on the CPU.

Both sides compute in float32 from the same weights; they differ in the
order of their sums (SDPA against an einsum, grouped GEMMs against an
expert loop, the absorbed product against the plain one), which moves the
logits by ~5e-6 at these sizes (logits of magnitude 4). The tolerances sit well above that and far
below what a wrong mask, position, expert or weight moves (0.1 and more).
"""

import cmath

import pytest
import torch

from aladin_torch.models import kimi_vl as K
from aladin_torch.ops import moe
from aladin_torch.tasks import decode_cache, decode_latent
from h100_bench.reference import kimi_vl as ref

TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_hidden_layers=3, num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
            routed_scaling_factor=2.446, kv_lora_rank=32, qk_rope_head_dim=8, v_head_dim=16,
            qk_nope_head_dim=16, num_experts_per_tok=2, first_k_dense_replace=1,
            norm_topk_prob=True, rms_norm_eps=1e-5, rope_theta=800000.0,
            media_placeholder_token_id=96, dtype="float32", topk_method="noaux_tc",
            n_group=1, topk_group=1, scoring_func="sigmoid", q_lora_rank=None)
PH = TINY["media_placeholder_token_id"]
ATOL = 1e-4  # float32 both sides, sums in another order: ~5e-6 observed


def tiny_weights(seed=0):
    """Published names -> float32 tensors: matrices normal(0, 0.15), norm
    scales 1 + normal(0, 0.1), a correction bias normal(0, 0.1)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in ref.spec(TINY):
        x = torch.randn(shape, generator=g)
        if name.endswith("e_score_correction_bias"):
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
    m = K.KimiVLForCausalLM(K.KimiVLConfig.from_dict(TINY)).eval()
    assert K.load_published(m, weights.items()) == len(weights)
    return m


def ref_logits(weights, seqs):
    return ref.logits(lambda names: {n: weights[n] for n in names}, TINY, seqs)


def prompts(seed=1, lengths=(9, 5, 12), images=(4, 0, 6)):
    """Left-padded prompts: [image placeholders | words], one image row of
    the embeddings a placeholder; (ids, mask, image rows, each row's
    unpadded ids and image)."""
    g = torch.Generator().manual_seed(seed)
    p = max(lengths)
    ids = torch.zeros(len(lengths), p, dtype=torch.long)
    mask = torch.zeros(len(lengths), p, dtype=torch.long)
    rows, imgs = [], []
    for r, (n, m) in enumerate(zip(lengths, images)):
        row = torch.randint(1, PH, (n,), generator=g)
        row[:m] = PH
        img = 0.3 * torch.randn(m, TINY["hidden_size"], generator=g)
        ids[r, p - n:], mask[r, p - n:] = row, 1
        rows.append((row, img if m else None))
        imgs.append(img)
    return ids, mask, torch.cat(imgs), rows


def test_full_forward_logits_match_the_reference(model, weights):
    ids, mask, image, rows = prompts()
    got = model(ids, mask, image)
    want = ref_logits(weights, [{"ids": r, "image": im, "prompt": len(r), "read": slice(None)}
                                for r, im in rows])
    for b, w in enumerate(want):
        n = w.shape[0]
        torch.testing.assert_close(got[b, -n:], w, atol=ATOL, rtol=0)


def test_cached_decoding_equals_the_full_forward_at_every_served_position(model, weights):
    """Prefill and cached steps on a left-padded ragged batch, fed the
    program's own greedy tokens, give the reference's full-forward logits at
    every served position; the greedy tokens and summed log-probabilities
    are those of each row decoded alone."""
    steps = 6
    ids, mask, image, rows = prompts()
    tokens, logprob = decode_cache.greedy_decode_cached(model, ids, image, mask, max_steps=steps)
    assert tokens.shape == (3, steps)
    cache, logits = decode_latent.prefill(model, ids, image, mask, steps)
    got = [logits]
    for j in range(steps - 1):
        got.append(decode_latent.decode_step(model, cache, tokens[:, j], j))
    got = torch.stack(got, dim=1)  # (B, steps, V)
    seqs = [{"ids": torch.cat([r, tokens[b, :-1]]), "image": im, "prompt": len(r),
             "read": slice(len(r) - 1, len(r) - 1 + steps)} for b, (r, im) in enumerate(rows)]
    for b, want in enumerate(ref_logits(weights, seqs)):
        torch.testing.assert_close(got[b], want, atol=ATOL, rtol=0)
        served = want.gather(1, tokens[b][:, None])[:, 0]
        assert (want.amax(dim=1) - served).max() < ATOL
    lp = torch.log_softmax(got, dim=-1).gather(2, tokens[..., None])[..., 0].sum(dim=1)
    torch.testing.assert_close(logprob, lp, atol=ATOL, rtol=0)
    for b, (r, im) in enumerate(rows):
        alone, alone_lp = decode_cache.greedy_decode_cached(
            model, r[None], im, torch.ones(1, len(r), dtype=torch.long), max_steps=steps)
        assert torch.equal(alone[0], tokens[b])
        torch.testing.assert_close(alone_lp[0], logprob[b], atol=ATOL, rtol=0)


def test_absorbed_step_equals_the_plain_attention(model):
    """The last query of a sequence through ``attend_absorbed`` over the
    latent rows equals the plain form's last row."""
    attn = model.layers[1].self_attn
    g = torch.Generator().manual_seed(3)
    s = 11
    h = torch.randn(1, s, TINY["hidden_size"], generator=g)
    rot = model.rope(torch.arange(s)[None] + 4)
    q_nope, q_pe = attn.queries(h, rot)
    lat = attn.latent(h, rot)
    causal = torch.ones(s, s, dtype=torch.bool).tril()[None, None]
    plain = attn.attend(q_nope, q_pe, lat, causal)[:, -1]
    absorbed = attn.attend_absorbed(q_nope[:, -1], q_pe[:, -1], lat, torch.zeros(1, 1, s))
    torch.testing.assert_close(absorbed, plain, atol=1e-5, rtol=0)


def _per_token_loop(h, gw, bias, gate_up, down, k, scale):
    out = torch.zeros_like(h)
    width = down.shape[-1]
    for t in range(h.shape[0]):
        s = torch.sigmoid(gw @ h[t])
        top = torch.topk(s + bias, k).indices
        w = s[top] / s[top].sum() * scale
        for e, we in zip(top.tolist(), w):
            gu = gate_up[e] @ h[t]
            out[t] += we * (down[e] @ (torch.nn.functional.silu(gu[:width]) * gu[width:]))
    return out


def test_grouped_dispatch_equals_a_per_token_loop():
    g = torch.Generator().manual_seed(4)
    t, hid, e, width, k = 37, 64, 8, 32, 2
    h = torch.randn(t, hid, generator=g)
    gw = 0.3 * torch.randn(e, hid, generator=g)
    bias = 0.1 * torch.randn(e, generator=g)
    gate_up = 0.2 * torch.randn(e, 2 * width, hid, generator=g)
    down = 0.2 * torch.randn(e, hid, width, generator=g)
    hits = torch.zeros((), dtype=torch.int64)
    got = moe.moe_forward(h, gw, bias, gate_up, down, top_k=k, scale=2.446, hits=hits)
    want = _per_token_loop(h, gw, bias, gate_up, down, k, 2.446)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    chosen = moe.route(h, gw, bias, k, 2.446)[1]
    assert int(hits) == len(set(chosen.flatten().tolist()))


def test_correction_bias_changes_the_choice_and_not_the_weights():
    """Scores [0.9, 0.8, 0.7, 0.1] with a bias that lifts expert 3 over
    expert 1: the choice is {0, 3}, in the program and the reference; the
    weights are the unbiased scores of 0 and 3 over their sum, times the
    scale. Without the bias the choice is {0, 1}."""
    s = torch.tensor([0.9, 0.8, 0.7, 0.1])
    h = torch.eye(4)[:1]
    gw = torch.zeros(4, 4)
    gw[:, 0] = torch.log(s / (1 - s))  # expert e's score is s[e]
    bias = torch.tensor([0.0, 0.0, 0.0, 0.75])
    w, chosen = moe.route(h, gw, bias, 2, 2.0)
    assert chosen[0].tolist() == [0, 3]
    torch.testing.assert_close(w[0], torch.tensor([0.9, 0.1]) * 2.0, atol=1e-6, rtol=0)
    w0, chosen0 = moe.route(h, gw, torch.zeros(4), 2, 2.0)
    assert chosen0[0].tolist() == [0, 1]
    c = dict(TINY, n_routed_experts=4, num_experts_per_tok=2, routed_scaling_factor=2.0)
    W = {"p.mlp.gate.weight": gw, "p.mlp.gate.e_score_correction_bias": bias}
    for e in range(4):
        W.update({f"p.mlp.experts.{e}.{n}_proj.weight": torch.zeros(s_)
                  for n, s_ in (("gate", (32, 4)), ("up", (32, 4)), ("down", (4, 32)))})
    W.update({f"p.mlp.shared_experts.{n}_proj.weight": torch.zeros(s_)
              for n, s_ in (("gate", (32, 4)), ("up", (32, 4)), ("down", (4, 32)))})
    assert sorted(ref.moe(W, "p.", c, h, ref.Precision("f32"))[1][0].tolist()) == [0, 3]


def test_rope_keeps_the_published_convention():
    """The projection's rotary dimensions are interleaved pairs (x_2i,
    x_2i+1): rotating pair i by angle pos * theta^(-2i/d) as a complex
    number puts its real part at i and its imaginary part at i + d/2. The
    program, the reference and this complex rotation agree, and the product
    of a rotated query and key depends only on their distance."""
    d, theta = 8, 800000.0
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, d, generator=g)
    pos = torch.tensor([0, 7, 300])
    got = K.apply_rope(x, K.rope_angles(pos, d, theta))
    want = torch.empty_like(x)
    for r in range(3):
        for i in range(d // 2):
            z = complex(x[r, 2 * i], x[r, 2 * i + 1]) * cmath.exp(
                1j * float(pos[r]) * theta ** (-2 * i / d))
            want[r, i], want[r, i + d // 2] = z.real, z.imag
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(ref.rope(x, pos, theta), want, atol=1e-5, rtol=0)
    q, k = torch.randn(d, generator=g), torch.randn(d, generator=g)

    def dot(m, n):
        r = K.apply_rope(torch.stack([q, k]), K.rope_angles(torch.tensor([m, n]), d, theta))
        return float(r[0] @ r[1])

    assert abs(dot(10, 3) - dot(110, 103)) < 1e-4


def test_published_keys_map_onto_the_stacked_experts(weights):
    """Every published name lands in a parameter: a per-expert gate / up /
    down in its rows of the stacked tensors, the correction bias in the
    gate; every parameter is written."""
    m = K.KimiVLForCausalLM(K.KimiVLConfig.from_dict(TINY))
    with torch.no_grad():
        for p in m.parameters():
            p.fill_(float("nan"))
    K.load_published(m, weights.items())
    params = dict(m.named_parameters())
    assert all(torch.isfinite(p).all() for p in params.values())
    pre = "language_model.model.layers.2.mlp."
    stacked = params[pre + "experts.gate_up_proj"]
    assert torch.equal(stacked[5, :32], weights[pre + "experts.5.gate_proj.weight"])
    assert torch.equal(stacked[5, 32:], weights[pre + "experts.5.up_proj.weight"])
    assert torch.equal(params[pre + "experts.down_proj"][7],
                       weights[pre + "experts.7.down_proj.weight"])
    assert torch.equal(params[pre + "gate.e_score_correction_bias"],
                       weights[pre + "gate.e_score_correction_bias"])
    assert K.stacked_key("language_model.model.layers.1.mlp.experts.63.up_proj.weight", 1408) == (
        "language_model.model.layers.1.mlp.experts.gate_up_proj", (63, slice(1408, 2816)))
    with pytest.raises(KeyError):
        K.load_published(m, [("language_model.model.layers.9.mlp.gate.weight", torch.zeros(1))])


def test_latent_decoder_spans_and_counters(model, tmp_path):
    """Under the profiler the latent decoder opens ``decode.cached`` /
    ``decode.prefill`` / ``decode.step`` and the MoE's three spans, and
    counts from shapes: ``moe.routed_tokens`` every (token, slot) pair of
    every MoE call, ``decode.latent_bytes`` the latent a step reads;
    ``moe.experts_hit`` the experts chosen, summed over the steps' calls.
    The traced tokens are the untraced ones."""
    from tests.test_torch_tracing import annotations, traced

    steps = 4
    ids, mask, image, _ = prompts()
    want = decode_cache.greedy_decode_cached(model, ids, image, mask, max_steps=steps)
    got, events, counted = traced(
        lambda: decode_cache.greedy_decode_cached(model, ids, image, mask, max_steps=steps),
        tmp_path)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name, n in (("decode.cached", 1), ("decode.prefill", 1), ("decode.step", steps - 1)):
        assert len(annotations(events, name)) == n, name
    moe_layers = TINY["num_hidden_layers"] - TINY["first_k_dense_replace"]
    calls = moe_layers * (1 + steps - 1)
    for name in ("moe.dispatch", "moe.experts", "moe.combine"):
        assert len(annotations(events, name)) == calls, name
    b, p = ids.shape
    k = TINY["num_experts_per_tok"]
    assert counted["moe.routed_tokens"] == moe_layers * k * (b * p + b * (steps - 1))
    width = TINY["kv_lora_rank"] + TINY["qk_rope_head_dim"]
    align = decode_latent.KEY_ALIGN
    slots = -(-(p + steps - 1) // align) * align
    keys = [min(-(-(p + j + 1) // align) * align, slots) for j in range(steps - 1)]
    assert counted["decode.latent_bytes"] == sum(
        TINY["num_hidden_layers"] * b * n * width * 4 for n in keys)
    assert moe_layers * (steps - 1) <= counted["moe.experts_hit"] <= (
        moe_layers * (steps - 1) * TINY["n_routed_experts"])


def test_a_generated_placeholder_id_is_a_word(model, weights):
    """Only the prompt's placeholders take image rows: a fed token equal to
    the placeholder id is embedded as a word by the cached step and by the
    reference alike."""
    ids, mask, image, rows = prompts()
    cache, _ = decode_latent.prefill(model, ids, image, mask, 3)
    fed = torch.full((ids.shape[0],), PH)
    got = decode_latent.decode_step(model, cache, fed, 0)
    seqs = [{"ids": torch.cat([r, fed[:1]]), "image": im, "prompt": len(r),
             "read": slice(len(r), len(r) + 1)} for r, im in rows]
    for b, want in enumerate(ref_logits(weights, seqs)):
        torch.testing.assert_close(got[b], want[0], atol=ATOL, rtol=0)
