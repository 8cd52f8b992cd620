"""The yardstick of the hybrid KDA / MLA decoder (Kimi-Linear): model FLOPs
of a batch counted from shapes, and the roofline bounds of the KDA
recurrence's prefill (K5) and step (K6), whatever implements them. Peaks
and bandwidth are ``lib/bounds.py``'s (one H100 SXM, 700 W).

Model FLOPs of a batch: every valid token once through every layer, twice
the parameters it multiplies (a KDA layer's projections q, k, v, f_a, f_b,
b, g_a, g_b and o, and its short convolutions; an MLA layer's projections
in the plain form; layer 0's dense SwiGLU; each MoE layer's router, the
pairs computed on the held experts (counted by the program) and the shared
expert), the KDA recurrence at 4 d_k d_v multiply-adds a token and head,
the plain MLA attention's 2 x heads x (qk + v) x keys (a token sees every
earlier token of its own document and itself), and the head where logits
are taken (a document's last prompt token and each fed token).

K5's bound of one call over ``tokens`` packed tokens of ``docs``
documents: the larger of
  * bytes over HBM bandwidth: the raw projections q, k, v, f (the decay's,
    before its bias and softplus) and b (beta's logit), all bf16, read
    once, o (bf16) written once, each document's final state (float32) and
    convolution tails (3 tokens of q, k and v in bf16) written once;
  * the recurrence's operations (2 x 4 x d_k x d_v a token and head) over
    the bf16 peak.
K6's bound of one step of ``batch`` rows: each row's state (float32) and
convolution tails read and written once, plus one token's q, k, v, f, b
and o, over HBM bandwidth.
"""

from __future__ import annotations

from typing import Sequence

from h100_bench.lib.bounds import HBM_BYTES_PER_S, PEAK_OPS_PER_S

BF16, F32 = 2, 4


def _kda(c: dict):
    lac = c["linear_attn_config"]
    return lac["num_heads"], lac["head_dim"], c.get("kda_gate_rank", 128)


def layer_kinds(c: dict):
    """(KDA layers, MLA layers, MoE layers)."""
    kda = len(c["linear_attn_config"]["kda_layers"])
    return kda, c["num_hidden_layers"] - kda, c["num_hidden_layers"] - c["first_k_dense_replace"]


def token_flops(c: dict) -> float:
    """FLOPs of one token through every layer's products, the attention's
    over keys and the routed experts left out."""
    h = c["hidden_size"]
    n, dk, r = _kda(c)
    d = n * dk
    kda = 2.0 * (4 * h * d + h * r + r * d + h * n + h * r + r * d) + 2.0 * 4 * 3 * d
    heads = c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    rank = c["kv_lora_rank"]
    mla = 2.0 * (h * heads * qk + h * (rank + c["qk_rope_head_dim"])
                 + rank * heads * (c["qk_nope_head_dim"] + c["v_head_dim"])
                 + heads * c["v_head_dim"] * h)
    width = c["moe_intermediate_size"]
    router = c.get("router_experts", c["num_experts"])
    moe = 2.0 * h * router + 6.0 * h * width * c["num_shared_experts"]
    n_kda, n_mla, n_moe = layer_kinds(c)
    dense = c["first_k_dense_replace"] * 6.0 * h * c["intermediate_size"]
    recurrence = 8.0 * n * dk * dk
    return n_kda * (kda + recurrence) + n_mla * mla + n_moe * moe + dense


def model_flops(c: dict, prompts: Sequence[int], new: int, held_pairs: float) -> float:
    """Model FLOPs of one batch: prompts of ``prompts`` valid tokens, ``new``
    greedy tokens each (the first from the prefill), ``held_pairs`` (token,
    expert) pairs computed on the held experts (module doc)."""
    heads = c["num_attention_heads"]
    per_key = 2.0 * heads * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"])
    _, n_mla, _ = layer_kinds(c)
    tokens = keys = 0.0
    for p in prompts:
        tokens += p + new - 1
        keys += p * (p + 1) / 2.0 + sum(p + j + 1 for j in range(new - 1))
    experts = 6.0 * c["hidden_size"] * c["moe_intermediate_size"] * held_pairs
    head = 2.0 * c["hidden_size"] * c["vocab_size"] * new * len(prompts)
    return tokens * token_flops(c) + n_mla * per_key * keys + experts + head


def k5_bound_s(c: dict, tokens: int, docs: int) -> float:
    """K5's least time for one call (module doc)."""
    n, dk, _ = _kda(c)
    d = n * dk
    n_bytes = tokens * (5 * d * BF16 + n * BF16) + docs * (n * dk * dk * F32 + 3 * 3 * d * BF16)
    ops = tokens * n * 8.0 * dk * dk
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["bf16"])


def k6_bound_s(c: dict, batch: int) -> float:
    """K6's least time for one step of ``batch`` rows (module doc)."""
    n, dk, _ = _kda(c)
    d = n * dk
    state = n * dk * dk * F32 + 3 * 3 * d * BF16
    token = 5 * d * BF16 + n * BF16
    return batch * (2 * state + token) / HBM_BYTES_PER_S
