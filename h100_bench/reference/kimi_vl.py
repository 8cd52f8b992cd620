"""Plain PyTorch Kimi-VL-A3B-Instruct language model (a DeepSeek-V3 block;
moonshotai/Kimi-VL-A3B-Instruct ``config.json``, DeepSeek-V3's
``modeling_deepseek.py``), in float32 with TF32 off: no kernel, cache,
batching or program code.

Per layer: RMSNorm (eps 1e-5); multi-head latent attention in its plain
form (q = W_q h; [c | k_pe] = W_kva h; c = RMSNorm(c); [k_nope | v] =
W_kvb c; RoPE on q_pe and the one shared k_pe; causal softmax over
q_nope.k_nope + q_pe.k_pe at 1 / sqrt(qk_nope + qk_rope); W_o); RMSNorm;
then the dense SwiGLU (layers below ``first_k_dense_replace``) or the
MoE: sigmoid scores, the top ``num_experts_per_tok`` of scores plus
``e_score_correction_bias``, the picked scores over their sum times
``routed_scaling_factor``, each token through each of its experts in a
loop over the experts, plus the shared experts' SwiGLU. Final RMSNorm,
untied ``lm_head``.

RoPE as ``modeling_deepseek.py`` applies it: the 64 rotary dimensions
come out of the projection as interleaved pairs, are reordered to
[evens | odds] and rotated by ``rotate_half`` with angles position x
theta^(-2i/64).

Departures from the published model:
  * no vision tower: MoonViT and its projector are not run; an image
    enters as its LM-input embeddings, which replace the prompt's
    placeholder tokens in order;
  * the weights are random and stand for no checkpoint (``spec`` lists
    them under the published names, experts one by one).

One layer at a time: ``logits`` asks ``weights`` for one layer's tensors,
runs every sequence through that layer (the attention one sequence at a
time, the MoE token by token in a loop over the experts), and drops them,
so at published widths only one layer's float32 weights are held. The
benchmark's check calls ``embed``, ``layers`` and ``head`` itself, on the
program's own inputs of each layer. Its controls: ``Precision("fp8")``
rounds the operands and results of the expert GEMMs and of the head's to
float8 e4m3;
``correction=False`` routes without the correction bias.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference.precision import Precision

LM = "language_model."
BODY = LM + "model."


def spec(c: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(published name, shape) of every weight, in the benchmark's order:
    the embedding, each layer, the final norm and the head."""
    h = c["hidden_size"]
    out = [(BODY + "embed_tokens.weight", (c["vocab_size"], h))]
    for i in range(c["num_hidden_layers"]):
        out += layer_spec(c, i)
    return out + [(BODY + "norm.weight", (h,)), (LM + "lm_head.weight", (c["vocab_size"], h))]


def layer_spec(c: dict, i: int) -> List[Tuple[str, Tuple[int, ...]]]:
    h, n = c["hidden_size"], c["num_attention_heads"]
    nope, rope, v = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    rank, width = c["kv_lora_rank"], c["moe_intermediate_size"]
    p = f"{BODY}layers.{i}."
    out = [(p + "input_layernorm.weight", (h,)),
           (p + "self_attn.q_proj.weight", (n * (nope + rope), h)),
           (p + "self_attn.kv_a_proj_with_mqa.weight", (rank + rope, h)),
           (p + "self_attn.kv_a_layernorm.weight", (rank,)),
           (p + "self_attn.kv_b_proj.weight", (n * (nope + v), rank)),
           (p + "self_attn.o_proj.weight", (h, n * v)),
           (p + "post_attention_layernorm.weight", (h,))]
    if i < c["first_k_dense_replace"]:
        return out + swiglu_spec(p + "mlp.", h, c["intermediate_size"])
    out += [(p + "mlp.gate.weight", (c["n_routed_experts"], h)),
            (p + "mlp.gate.e_score_correction_bias", (c["n_routed_experts"],))]
    for e in range(c["n_routed_experts"]):
        out += swiglu_spec(f"{p}mlp.experts.{e}.", h, width)
    return out + swiglu_spec(p + "mlp.shared_experts.", h, width * c["n_shared_experts"])


def swiglu_spec(p: str, h: int, width: int):
    return [(p + "gate_proj.weight", (width, h)), (p + "up_proj.weight", (width, h)),
            (p + "down_proj.weight", (h, width))]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """``x`` (S, ..., d) in interleaved order, rotated at ``positions`` (S,)."""
    d = x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1).reshape(ang.shape[0], *([1] * (x.ndim - 2)), d)
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * ang.cos() + rotated * ang.sin()


def swiglu(W: Dict[str, torch.Tensor], p: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    a = F.silu(prec.linear(x, W[p + "gate_proj.weight"])) * prec.linear(x, W[p + "up_proj.weight"])
    return prec.linear(a, W[p + "down_proj.weight"])


def attention(W, p: str, c: dict, h: torch.Tensor) -> torch.Tensor:
    s = h.shape[0]
    n = c["num_attention_heads"]
    nope, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    rank = c["kv_lora_rank"]
    pos = torch.arange(s, device=h.device)
    q = (h @ W[p + "self_attn.q_proj.weight"].t()).reshape(s, n, nope + rd)
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], pos, c["rope_theta"])
    kv_a = h @ W[p + "self_attn.kv_a_proj_with_mqa.weight"].t()
    c_kv = rms_norm(kv_a[:, :rank], W[p + "self_attn.kv_a_layernorm.weight"], c["rms_norm_eps"])
    k_pe = rope(kv_a[:, rank:], pos, c["rope_theta"])  # (S, rope), shared by the heads
    kv = (c_kv @ W[p + "self_attn.kv_b_proj.weight"].t()).reshape(s, n, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    scores = (torch.einsum("qhd,khd->hqk", q_nope, k_nope)
              + torch.einsum("qhd,kd->hqk", q_pe, k_pe)) / math.sqrt(nope + rd)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, n * vd)
    return o @ W[p + "self_attn.o_proj.weight"].t()


def moe(W, p: str, c: dict, h: torch.Tensor, prec: Precision, chosen: torch.Tensor = None,
        correction: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the routed experts' sum plus the shared experts', the experts the
    reference picks (S, k) in descending order of their biased scores).
    ``chosen`` (S, k): sum over these experts instead of the picked ones,
    weighted by the reference's own scores of them. ``correction`` False:
    pick without ``e_score_correction_bias`` (a router fault, for the
    benchmark's control)."""
    scores = torch.sigmoid(h @ W[p + "mlp.gate.weight"].t())
    k = c["num_experts_per_tok"]
    biased = scores + W[p + "mlp.gate.e_score_correction_bias"] if correction else scores
    picked = torch.topk(biased, k, dim=-1).indices
    use = picked if chosen is None else chosen
    w = scores.gather(1, use)
    if c["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * c["routed_scaling_factor"]
    out = torch.zeros_like(h)
    for e in range(c["n_routed_experts"]):
        tok, slot = (use == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(W, f"{p}mlp.experts.{e}.", h[tok], prec)
            out.index_add_(0, tok, w[tok, slot, None] * y)
    return out + swiglu(W, p + "mlp.shared_experts.", h, Precision("f32")), picked


def layer(W, i: int, c: dict, x: torch.Tensor, prec: Precision):
    """(x (S, hidden) after layer i, the chosen experts or None)."""
    ys, chosen = layers(W, i, c, [x], prec)
    return ys[0], chosen


def layers(W, i: int, c: dict, xs: List[torch.Tensor], prec: Precision,
           chosen: torch.Tensor = None, correction: bool = True):
    """Layer i over sequences ``xs``, each (S_j, hidden): (the sequences
    after it, the experts the reference picks for all their tokens in
    order, or None). Attention runs a sequence at a time; the MoE, a
    per-token function, runs over all the sequences' tokens in one loop
    over the experts. ``chosen`` and ``correction``: as ``moe``'s, over the
    sequences' tokens in order."""
    p = f"{BODY}layers.{i}."
    eps = c["rms_norm_eps"]
    xs = [x + attention(W, p, c, rms_norm(x, W[p + "input_layernorm.weight"], eps)) for x in xs]
    h = rms_norm(torch.cat(xs), W[p + "post_attention_layernorm.weight"], eps)
    if i < c["first_k_dense_replace"]:
        y, picked = swiglu(W, p + "mlp.", h, Precision("f32")), None
    else:
        y, picked = moe(W, p, c, h, prec, chosen, correction)
    return [x + d for x, d in zip(xs, y.split([x.shape[0] for x in xs]))], picked


def embed(W, c: dict, s: dict) -> torch.Tensor:
    """(S, hidden) float32 input rows of a sequence (``logits``' form): the
    word embeddings, the image rows in the placeholders' places."""
    x = W[BODY + "embed_tokens.weight"][s["ids"]]
    if s.get("image") is not None:
        prompt = s["ids"][:s["prompt"]]
        slots = (prompt == c["media_placeholder_token_id"]).nonzero()[:, 0]
        x[slots] = s["image"].float()
    return x


def head(W, c: dict, x: torch.Tensor, prec: Precision = Precision("f32")) -> torch.Tensor:
    """float32 logits of final residual rows ``x``: the final RMSNorm and
    the untied ``lm_head`` (its product in ``prec``)."""
    return prec.linear(rms_norm(x, W[BODY + "norm.weight"], c["rms_norm_eps"]),
                       W[LM + "lm_head.weight"])


@torch.no_grad()
def logits(weights: Callable[[Sequence[str]], Dict[str, torch.Tensor]], c: dict,
           seqs: Sequence[dict], prec: Precision = Precision("f32")
           ) -> List[torch.Tensor]:
    """Each sequence's float32 logits (n, vocab) at its positions
    ``read`` (a slice). A sequence is ``{"ids": (S,) int64, "image":
    (placeholders, hidden) or None, "prompt": int, "read": slice}``,
    unpadded; the image rows fill the placeholders among the first
    ``prompt`` ids (a generated token that equals the placeholder id is a
    word).
    ``weights(names)`` returns those tensors as float32."""
    with prec.context():
        W = weights([BODY + "embed_tokens.weight"])
        xs = [embed(W, c, s) for s in seqs]
        del W
        for i in range(c["num_hidden_layers"]):
            W = weights([n for n, _ in layer_spec(c, i)])
            xs = layers(W, i, c, xs, prec)[0]
            del W
        W = weights([BODY + "norm.weight", LM + "lm_head.weight"])
        return [head(W, c, x[s["read"]], prec) for x, s in zip(xs, seqs)]
