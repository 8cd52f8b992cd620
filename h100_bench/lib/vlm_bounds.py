"""The yardstick of the latent-attention MoE decoder (Kimi-VL's language
model): model FLOPs counted from shapes, and the routed experts' roofline
bound. Peaks and bandwidth are ``lib/bounds.py``'s (one H100 SXM, 700 W).

Model FLOPs of a token: twice the parameters its forward multiplies (the
attention projections in the plain form, layer 0's dense SwiGLU, each MoE
layer's router, ``k`` routed experts and the shared experts, and the head
where logits are taken) plus the plain attention's 2 x heads x (qk + v)
x keys, the token seeing every earlier valid token and itself.

The routed experts' bound of one MoE call of ``pairs`` (token, expert)
pairs over ``hit`` distinct experts: the larger of
  * bytes / HBM bandwidth: each hit expert's three bf16 matrices read once,
    and the two grouped GEMMs' inputs read and outputs written once
    (pairs x (hidden + 2 width + width + hidden) bf16 values);
  * operations / the bf16 peak: pairs x 6 x hidden x width.
"""

from __future__ import annotations

from typing import Tuple

from h100_bench.lib.bounds import HBM_BYTES_PER_S, PEAK_OPS_PER_S

BF16 = 2


def token_linear_flops(c: dict) -> Tuple[float, float]:
    """(FLOPs of one token through the dense layers, through one MoE layer):
    their products, the attention's over keys left out."""
    h, n = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    attn = 2.0 * (h * n * qk + h * (c["kv_lora_rank"] + c["qk_rope_head_dim"])
                  + c["kv_lora_rank"] * n * (c["qk_nope_head_dim"] + c["v_head_dim"])
                  + n * c["v_head_dim"] * h)
    width = c["moe_intermediate_size"]
    moe = (2.0 * h * c["n_routed_experts"]
           + 6.0 * h * width * (c["num_experts_per_tok"] + c["n_shared_experts"]))
    dense_layers = c["first_k_dense_replace"]
    return dense_layers * (attn + 6.0 * h * c["intermediate_size"]), attn + moe


def sequence_flops(c: dict, prompt: int, new: int) -> float:
    """Model FLOPs of one image's prompt (``prompt`` valid tokens) and
    ``new`` greedy tokens: the prompt once, the head on its last token, then
    ``new - 1`` steps of one token with the head."""
    n = c["num_attention_heads"]
    per_key = 2.0 * n * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"])
    layers, moe_layers = c["num_hidden_layers"], c["num_hidden_layers"] - c["first_k_dense_replace"]
    dense, moe = token_linear_flops(c)
    head = 2.0 * c["hidden_size"] * c["vocab_size"]
    keys = prompt * (prompt + 1) / 2.0 + sum(prompt + j + 1 for j in range(new - 1))
    tokens = prompt + new - 1
    return tokens * (dense + moe_layers * moe) + layers * per_key * keys + new * head


def expert_bound_s(c: dict, pairs: float, hit: float) -> Tuple[float, float]:
    """(bytes over bandwidth, operations over the bf16 peak) in seconds of
    one MoE call's routed experts (module doc)."""
    h, w = c["hidden_size"], c["moe_intermediate_size"]
    n_bytes = hit * 3 * h * w * BF16 + pairs * (2 * h + 3 * w) * BF16
    ops = pairs * 6.0 * h * w
    return n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["bf16"]


def prefill_expert_bound_s(c: dict, tokens: int) -> float:
    """The routed experts' bound of one batch's prefill of ``tokens`` valid
    prompt tokens, every MoE layer, each layer's calls taken as one call
    that hits every expert: no more than the sum of the calls' own bounds
    (the program may split a layer's prefill into calls and runs the pads
    too), so the share it gives is never above the truth."""
    moe_layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    return moe_layers * max(expert_bound_s(c, tokens * c["num_experts_per_tok"],
                                           c["n_routed_experts"]))


def step_expert_bound_s(c: dict, batch: int, calls: int, hit_total: float) -> float:
    """The routed experts' bound of ``calls`` cached-step MoE calls of
    ``batch`` tokens that hit ``hit_total`` experts in all: the larger of
    the summed byte and operation terms (each term summed over the calls; a
    step call is bound by bytes many times over, so this is the sum of the
    calls' bounds)."""
    if calls <= 0:
        return 0.0
    n_bytes, ops = expert_bound_s(c, batch * c["num_experts_per_tok"], hit_total / calls)
    return calls * max(n_bytes, ops)
