"""Plain PyTorch Kimi-Linear-48B-A3B-Instruct (moonshotai/Kimi-Linear-48B-
A3B-Instruct ``config.json``; the Kimi Linear technical report, arXiv
2510.26692), in float32 with TF32 off: no kernel, cache, packing or
program code.

Layers (0-based; the config's ``linear_attn_config`` counts from 1): 20
KDA layers and 7 MLA layers (3, 7, 11, 15, 19, 23, 26). Per layer:
RMSNorm (eps 1e-5), the attention, RMSNorm, then the dense SwiGLU (layer
0) or the MoE; final RMSNorm, untied ``lm_head``.

KDA, per token t and head n (d_k = d_v = 128): q, k, v = SiLU of the
causal depthwise width-4 convolutions (from zeros at the sequence's start)
of W_q h, W_k h, W_v h; q / |q| / sqrt(128) and k / |k| (|x| = sqrt(sum
x^2 + 1e-6)); log alpha = -exp(A_log[n]) softplus(W_fb W_fa h + dt_bias)
per channel; beta = sigmoid(W_b h)[n]; S <- Diag(alpha) S, S <- S + beta
k (v - S^T k)^T, o = S^T q with S zero at the start; o <- RMSNorm_head(o)
(one 128-weight, eps 1e-5) * sigmoid(W_gb W_ga h + b_g); W_o o. Given
twice: ``kda_recurrent``, token by token, and ``kda_chunked``, the same
recurrence regrouped in chunks of 64 with the pairwise decays exp(G_i -
G_j), i >= j, per channel written out (G the cumulative log-decay inside
a chunk, so no exponent is positive) and each chunk's updates solved as
one unit-triangular system.

MLA without rotation (``mla_use_nope``): q = W_q h per head [q_nope (128)
| q_pe (64)]; [c | k_pe] = W_kva h; c = RMSNorm(c); [k_nope | v] = W_kvb c;
causal softmax over q_nope.k_nope + q_pe.k_pe at 1 / sqrt(192), in its
plain (unabsorbed) form; W_o.

MoE: sigmoid scores over the router's 256 outputs, the top 8 of scores
plus ``e_score_correction_bias``, the picked scores over their sum times
``routed_scaling_factor``; each token through its picked experts that this
card holds, in a loop over the held experts, plus the shared expert.

Departures from the published model:
  * the expert share: the card holds ``num_experts`` (64) of the router's
    ``router_experts`` (256) from ``expert_offset``; the routed terms of
    the other experts are left out, as on each card of an EP-4 deployment
    (the router still ranks all 256 and normalises over all 8 picks);
  * assumed KDA parts, as the ``fla`` library's reference KDA layer
    (``fla/layers/kda.py``) has them, since the catalog's config does not
    give them: the low-rank decay and gate projections of width 128, the
    gated output norm and its bias ``b_g``;
  * the weights are random and stand for no checkpoint (``spec`` lists
    them under the port's names, experts one by one).

One layer at a time, as ``reference/kimi_vl.py``: ``layers`` takes one
layer's tensors and the sequences' inputs of that layer. The benchmark's
controls: ``Precision("fp8")`` rounds every GEMM's operands and result to
float8 e4m3; ``state_dtype=torch.bfloat16`` holds the KDA state in bf16
(rounded after every token's update, token by token).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference.kimi_vl import rms_norm, swiglu_spec
from h100_bench.reference.precision import Precision

BODY = "model."
CHUNK = 64
QUERY_BLOCK = 1024  # the plain MLA's queries at a time
EPS_QK = 1e-6


def is_kda(c: dict, i: int) -> bool:
    return i + 1 in c["linear_attn_config"]["kda_layers"]


def kda_dims(c: dict) -> Tuple[int, int, int]:
    """(heads, head width, low-rank gate width)."""
    lac = c["linear_attn_config"]
    return lac["num_heads"], lac["head_dim"], c.get("kda_gate_rank", 128)


def held(c: dict) -> range:
    """The router's experts this card holds."""
    first = c.get("expert_offset", 0)
    return range(first, first + c["num_experts"])


def spec(c: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every weight, in the benchmark's order: the
    embedding, each layer, the final norm and the head."""
    h = c["hidden_size"]
    out = [(BODY + "embed_tokens.weight", (c["vocab_size"], h))]
    for i in range(c["num_hidden_layers"]):
        out += layer_spec(c, i)
    return out + [(BODY + "norm.weight", (h,)), ("lm_head.weight", (c["vocab_size"], h))]


def layer_spec(c: dict, i: int) -> List[Tuple[str, Tuple[int, ...]]]:
    h = c["hidden_size"]
    p = f"{BODY}layers.{i}."
    out = [(p + "input_layernorm.weight", (h,))]
    a = p + "self_attn."
    if is_kda(c, i):
        n, dk, r = kda_dims(c)
        d = n * dk
        out += [(a + "q_proj.weight", (d, h)), (a + "k_proj.weight", (d, h)),
                (a + "v_proj.weight", (d, h)), (a + "q_conv1d.weight", (d, 4)),
                (a + "k_conv1d.weight", (d, 4)), (a + "v_conv1d.weight", (d, 4)),
                (a + "f_a_proj.weight", (r, h)), (a + "f_b_proj.weight", (d, r)),
                (a + "dt_bias", (d,)), (a + "A_log", (n,)), (a + "b_proj.weight", (n, h)),
                (a + "g_a_proj.weight", (r, h)), (a + "g_b_proj.weight", (d, r)),
                (a + "g_b_proj.bias", (d,)), (a + "o_norm.weight", (dk,)),
                (a + "o_proj.weight", (h, d))]
    else:
        n = c["num_attention_heads"]
        nope, rope, v = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
        rank = c["kv_lora_rank"]
        out += [(a + "q_proj.weight", (n * (nope + rope), h)),
                (a + "kv_a_proj_with_mqa.weight", (rank + rope, h)),
                (a + "kv_a_layernorm.weight", (rank,)),
                (a + "kv_b_proj.weight", (n * (nope + v), rank)),
                (a + "o_proj.weight", (h, n * v))]
    out.append((p + "post_attention_layernorm.weight", (h,)))
    if i < c["first_k_dense_replace"]:
        return out + swiglu_spec(p + "mlp.", h, c["intermediate_size"])
    router = c.get("router_experts", c["num_experts"])
    width = c["moe_intermediate_size"]
    out += [(p + "mlp.gate.weight", (router, h)),
            (p + "mlp.gate.e_score_correction_bias", (router,))]
    for e in held(c):
        out += swiglu_spec(f"{p}mlp.experts.{e}.", h, width)
    return out + swiglu_spec(p + "mlp.shared_experts.", h, width * c["num_shared_experts"])


def swiglu(W, p: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    a = F.silu(prec.linear(x, W[p + "gate_proj.weight"])) * prec.linear(x, W[p + "up_proj.weight"])
    return prec.linear(a, W[p + "down_proj.weight"])


# -- KDA ---------------------------------------------------------------------


def short_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of ``x`` (T, C) with ``w``
    (C, 4), ``w[:, 3]`` on the token itself, from zeros before the start."""
    t = x.shape[0]
    xp = torch.cat([x.new_zeros(3, x.shape[1]), x])
    return F.silu(sum(xp[i:i + t] * w[:, i] for i in range(4)))


def kda_inputs(W, p: str, c: dict, h: torch.Tensor, prec: Precision):
    """(q, k, v, log alpha (T, H, d), beta (T, H)) of one sequence's rows
    ``h`` (T, hidden)."""
    n, dk, _ = kda_dims(c)
    a = p + "self_attn."
    t = h.shape[0]

    def proj(name):
        return short_conv(prec.linear(h, W[a + f"{name}_proj.weight"]),
                          W[a + f"{name}_conv1d.weight"]).reshape(t, n, dk)

    q, k, v = proj("q"), proj("k"), proj("v")
    q = q * torch.rsqrt(q.pow(2).sum(-1, keepdim=True) + EPS_QK) / math.sqrt(dk)
    k = k * torch.rsqrt(k.pow(2).sum(-1, keepdim=True) + EPS_QK)
    f = prec.linear(prec.linear(h, W[a + "f_a_proj.weight"]), W[a + "f_b_proj.weight"])
    g = -torch.exp(W[a + "A_log"])[:, None] * F.softplus(f + W[a + "dt_bias"]).reshape(t, n, dk)
    beta = torch.sigmoid(prec.linear(h, W[a + "b_proj.weight"]))
    return q, k, v, g, beta


def kda_recurrent(q, k, v, g, beta, state: Optional[torch.Tensor] = None,
                  state_dtype: torch.dtype = torch.float32):
    """The recurrence token by token over (B, T, H, d) inputs (beta (B, T,
    H)): (o (B, T, H, d), the final state (B, H, d, d)). ``state_dtype``:
    the state is rounded to it after every token (the bf16-state control)."""
    b, t, n, dk = k.shape
    s = (torch.zeros(b, n, dk, v.shape[-1], device=k.device) if state is None
         else state.clone())
    out = []
    for i in range(t):
        s = s * torch.exp(g[:, i])[..., None]
        u = v[:, i] - torch.einsum("bhkv,bhk->bhv", s, k[:, i])
        s = s + beta[:, i, :, None, None] * k[:, i, ..., None] * u[..., None, :]
        if state_dtype != torch.float32:
            s = s.to(state_dtype).float()
        out.append(torch.einsum("bhkv,bhk->bhv", s, q[:, i]))
    return torch.stack(out, dim=1), s


def kda_chunked(q, k, v, g, beta, chunk: int = CHUNK, group: int = 16):
    """``kda_recurrent`` regrouped in chunks (module doc): the same (o,
    final state) from zero, over (B, T, H, d) inputs. Within a chunk, with
    G the cumulative log-decay and S0 the state at its start, the updates
    u solve (I + Diag(beta) A) U = Diag(beta)(V - (e^G * K) S0), A_ij =
    sum_c k_i k_j e^(G_i - G_j) (j < i); o_i = (e^G_i * q_i) S0 + sum_(j <=
    i) B_ij u_j, B_ij = sum_c q_i k_j e^(G_i - G_j); the next state is e^G_C
    * S0 + (e^(G_C - G) * K)^T U. ``group`` chunks' pairwise decays are
    held at once."""
    b, t, n, dk = k.shape
    dv = v.shape[-1]
    pad = (-t) % chunk
    q, k, v, g = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v, g))
    beta = F.pad(beta, (0, 0, 0, pad))
    m = (t + pad) // chunk

    def chunks(x):  # (B, T, H, ...) -> (B, m, H, C, ...)
        return x.reshape(b, m, chunk, n, *x.shape[3:]).transpose(2, 3)

    q, k, v, g, beta = chunks(q), chunks(k), chunks(v), chunks(g), chunks(beta)
    G = g.cumsum(dim=3)
    incl = torch.ones(chunk, chunk, dtype=torch.bool, device=k.device).tril()
    strict = incl.tril(-1)
    A = torch.empty(b, m, n, chunk, chunk, device=k.device)
    Bm = torch.empty_like(A)
    for lo in range(0, m, group):
        s = slice(lo, lo + group)
        diff = G[:, s, :, :, None, :] - G[:, s, :, None, :, :]  # [i, j]
        decay = torch.exp(diff.masked_fill(~incl[:, :, None], float("-inf")))
        A[:, s] = torch.einsum("bmhik,bmhjk,bmhijk->bmhij", k[:, s], k[:, s], decay)
        Bm[:, s] = torch.einsum("bmhik,bmhjk,bmhijk->bmhij", q[:, s], k[:, s], decay)
        del diff, decay
    A = A.masked_fill(~strict, 0.0)
    eye = torch.eye(chunk, device=k.device)
    S = torch.zeros(b, n, dk, dv, device=k.device)
    out = torch.empty(b, m, n, chunk, dv, device=k.device)
    for i in range(m):
        eg = torch.exp(G[:, i])  # (B, H, C, d)
        rhs = beta[:, i, ..., None] * (v[:, i] - (k[:, i] * eg) @ S)
        lower = eye + beta[:, i, ..., None] * A[:, i]
        u = torch.linalg.solve_triangular(lower, rhs, upper=False, unitriangular=True)
        out[:, i] = (q[:, i] * eg) @ S + Bm[:, i] @ u
        last = G[:, i, :, -1:]  # (B, H, 1, d)
        S = torch.exp(last)[..., 0, :, None] * S \
            + (k[:, i] * torch.exp(last - G[:, i])).transpose(-1, -2) @ u
    return out.transpose(2, 3).reshape(b, m * chunk, n, dv)[:, :t], S


def kda_attention(W, p: str, c: dict, hs: List[torch.Tensor], prec: Precision,
                  state_dtype: torch.dtype = torch.float32):
    """KDA over sequences' rows ``hs`` (each (T_j, hidden), normalised):
    (each sequence's o_proj output, their final states (n, H, d, d)). In
    float32 each sequence runs ``kda_chunked``; with a lower ``state_dtype``
    the sequences run ``kda_recurrent`` together, padded at their ends with
    tokens that change nothing (beta 0, no decay)."""
    a = p + "self_attn."
    n, dk, _ = kda_dims(c)
    feats = [kda_inputs(W, p, c, h, prec) for h in hs]
    if state_dtype == torch.float32:
        runs = [kda_chunked(*(x[None] for x in f)) for f in feats]
        os_, states = [o[0] for o, _ in runs], torch.cat([s for _, s in runs])
    else:
        t = max(h.shape[0] for h in hs)
        padded = [torch.stack([F.pad(f[i], (0, 0) * (f[i].dim() - 1) + (0, t - f[i].shape[0]))
                               for f in feats]) for i in range(5)]
        o, states = kda_recurrent(*padded, state_dtype=state_dtype)
        os_ = [o[j, :h.shape[0]] for j, h in enumerate(hs)]
    ys = []
    for o, h in zip(os_, hs):
        gate = torch.sigmoid(prec.linear(prec.linear(h, W[a + "g_a_proj.weight"]),
                                         W[a + "g_b_proj.weight"], W[a + "g_b_proj.bias"]))
        o = rms_norm(o, W[a + "o_norm.weight"], c["rms_norm_eps"]).reshape(h.shape[0], n * dk)
        ys.append(prec.linear(o * gate, W[a + "o_proj.weight"]))
    return ys, states


# -- MLA, MoE ----------------------------------------------------------------


def mla_attention(W, p: str, c: dict, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Causal MLA without rotation over one sequence's rows ``h`` (S,
    hidden), ``QUERY_BLOCK`` queries at a time."""
    s = h.shape[0]
    n = c["num_attention_heads"]
    nope, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    rank = c["kv_lora_rank"]
    a = p + "self_attn."
    q = prec.linear(h, W[a + "q_proj.weight"]).reshape(s, n, nope + rd)
    kv_a = prec.linear(h, W[a + "kv_a_proj_with_mqa.weight"])
    c_kv = rms_norm(kv_a[:, :rank], W[a + "kv_a_layernorm.weight"], c["rms_norm_eps"])
    k_pe = kv_a[:, rank:]
    kv = prec.linear(c_kv, W[a + "kv_b_proj.weight"]).reshape(s, n, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    o = torch.empty(s, n, vd, device=h.device)
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, s)
        scores = (torch.einsum("qhd,khd->hqk", q[lo:hi, :, :nope], k_nope[:hi])
                  + torch.einsum("qhd,kd->hqk", q[lo:hi, :, nope:], k_pe[:hi])) \
            / math.sqrt(nope + rd)
        seen = (torch.arange(hi, device=h.device)[None, :]
                <= torch.arange(lo, hi, device=h.device)[:, None])
        probs = torch.softmax(scores.masked_fill(~seen, float("-inf")), dim=-1)
        o[lo:hi] = torch.einsum("hqk,khd->qhd", probs, v[:hi])
    return prec.linear(o.reshape(s, n * vd), W[a + "o_proj.weight"])


def moe(W, p: str, c: dict, h: torch.Tensor, prec: Precision, chosen: torch.Tensor = None,
        correction: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the held experts' routed sum plus the shared expert's, the experts
    the reference picks (S, k) over all the router's). ``chosen``: sum over
    these picks instead, weighted by the reference's own scores of them;
    ``correction`` False: pick without the correction bias."""
    scores = torch.sigmoid(h @ W[p + "mlp.gate.weight"].t())
    k = c["num_experts_per_token"]
    biased = scores + W[p + "mlp.gate.e_score_correction_bias"] if correction else scores
    picked = torch.topk(biased, k, dim=-1).indices
    use = picked if chosen is None else chosen
    w = scores.gather(1, use)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * c["routed_scaling_factor"]
    out = torch.zeros_like(h)
    for e in held(c):
        tok, slot = (use == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(W, f"{p}mlp.experts.{e}.", h[tok], prec)
            out.index_add_(0, tok, w[tok, slot, None] * y)
    return out + swiglu(W, p + "mlp.shared_experts.", h, prec), picked


def layers(W, i: int, c: dict, xs: List[torch.Tensor], prec: Precision,
           chosen: torch.Tensor = None, correction: bool = True,
           state_dtype: torch.dtype = torch.float32):
    """Layer i over sequences ``xs`` (each (S_j, hidden)): (the sequences
    after it, the experts the reference picks for all their tokens in order
    or None, the KDA layer's final states (n, H, d, d) or None)."""
    p = f"{BODY}layers.{i}."
    eps = c["rms_norm_eps"]
    hs = [rms_norm(x, W[p + "input_layernorm.weight"], eps) for x in xs]
    states = None
    if is_kda(c, i):
        ys, states = kda_attention(W, p, c, hs, prec, state_dtype)
    else:
        ys = [mla_attention(W, p, c, h, prec) for h in hs]
    xs = [x + y for x, y in zip(xs, ys)]
    h = rms_norm(torch.cat(xs), W[p + "post_attention_layernorm.weight"], eps)
    if i < c["first_k_dense_replace"]:
        y, picked = swiglu(W, p + "mlp.", h, prec), None
    else:
        y, picked = moe(W, p, c, h, prec, chosen, correction)
    return [x + d for x, d in zip(xs, y.split([x.shape[0] for x in xs]))], picked, states


def embed(W, ids: torch.Tensor) -> torch.Tensor:
    return W[BODY + "embed_tokens.weight"][ids]


def head(W, c: dict, x: torch.Tensor, prec: Precision = Precision("f32")) -> torch.Tensor:
    """float32 logits of final residual rows ``x``."""
    return prec.linear(rms_norm(x, W[BODY + "norm.weight"], c["rms_norm_eps"]),
                       W["lm_head.weight"])


@torch.no_grad()
def logits(weights: Callable[[Sequence[str]], Dict[str, torch.Tensor]], c: dict,
           seqs: Sequence[torch.Tensor], prec: Precision = Precision("f32")
           ) -> List[torch.Tensor]:
    """Each sequence's (S, vocab) float32 logits at every position; each
    sequence (S,) int64 runs alone from its first token. ``weights(names)``
    returns those tensors as float32."""
    with prec.context():
        W = weights([BODY + "embed_tokens.weight"])
        xs = [embed(W, s) for s in seqs]
        for i in range(c["num_hidden_layers"]):
            W = weights([n for n, _ in layer_spec(c, i)])
            xs = layers(W, i, c, xs, prec)[0]
        W = weights([BODY + "norm.weight", "lm_head.weight"])
        return [head(W, c, x, prec) for x in xs]
