"""Kimi-VL-A3B-Instruct's language model (moonshotai/Kimi-VL-A3B-Instruct,
``config.json``'s ``text_config``): a DeepSeek-V3 block, causal, in the
configuration's dtype.

Per layer l, with ``x`` the residual stream (B, S, hidden):

  * ``h = RMSNorm_in(x)``;
  * queries: ``q = W_q h`` (no low-rank query: ``q_lora_rank`` null), per
    head ``[q_nope (128) | q_pe (64)]``;
  * keys and values through the latent: ``[c | k_pe] = W_kva h`` (512 +
    64), ``c = RMSNorm_kv(c)``, ``[k_nope | v] = W_kvb c`` per head (128 +
    128); RoPE on ``q_pe`` and on ``k_pe``, one ``k_pe`` shared by the 16
    heads;
  * causal softmax over ``q_nope . k_nope + q_pe . k_pe`` scaled by
    1 / sqrt(192); ``x += W_o [each head's attention-weighted v]``;
  * ``h = RMSNorm_post(x)``; layer 0 (``first_k_dense_replace``):
    ``x += down(silu(gate h) * up h)``, width 11264; layers 1-26: the
    routed MoE of ``ops/moe.py`` (sigmoid scores in f32, top-6 of scores
    plus the correction bias, the picked scores normalised and scaled by
    2.446, 64 SwiGLU experts of width 1408) plus the shared experts as one
    SwiGLU of width 2 x 1408;
  * then the final RMSNorm and the untied ``lm_head`` over 163,840 words.

RoPE keeps ``modeling_deepseek.py``'s convention: the projection emits the
64 rotary dimensions as interleaved pairs (x0, x1), (x2, x3), ...; they are
reordered to [x0, x2, ..., x62 | x1, x3, ..., x63] and rotated by
``rotate_half`` with cos / sin of [freqs | freqs], freqs = position x
theta^(-2i/64). The latent cache holds ``k_pe`` after this rotation, in
the reordered layout, and the queries are rotated the same way, so their
products are the published ones. The angles and the rotation are computed
in float32 (as a complex product a pair) and rounded once to the model's
dtype.

Images: MoonViT and its projector are not run. An image enters as its
LM-input embeddings (one 2048-d row a merged patch), which replace the
prompt's ``media_placeholder_token_id`` positions in order.

Prompts are left-padded: ``attention_mask`` (B, S) is 1 on a row's tokens
and 0 on its leading pads; positions count from each row's first token. A
pad query attends to itself alone, so every row of the softmax has a key
and the pads' latent rows stay finite.

State-dict keys are the published ``language_model.model.layers.N.…``
names, except that each MoE layer holds its experts stacked for the grouped
GEMMs: ``mlp.experts.gate_up_proj`` (E, 2 x 1408, hidden), the gate's rows
first, and ``mlp.experts.down_proj`` (E, hidden, 1408). ``stacked_key``
maps a published per-expert name onto them and ``load_published`` loads a
published state dict tensor by tensor.

The cached greedy decoder is ``tasks/decode_latent.py``; it calls the
pieces below (``queries``, ``latent``, ``attend_absorbed``,
``feed_forward``) layer by layer; its prefill is ``run``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aladin_torch.ops import moe

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class KimiVLConfig:
    """The language model's published settings (``text_config``)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    max_position_embeddings: int = 131072
    media_placeholder_token_id: int = 163605
    dtype: str = "bfloat16"
    # shared with models/kimi_linear.py: MLA without rotation, and a share
    # of the routed experts held (``held_experts`` of them from
    # ``expert_offset``; None: all of them)
    mla_use_nope: bool = False
    held_experts: Optional[int] = None
    expert_offset: int = 0

    def __post_init__(self):
        if self.q_lora_rank is not None:
            raise NotImplementedError("only q_lora_rank null (Kimi-VL-A3B's) is built")
        if (self.scoring_func, self.topk_method, self.n_group, self.topk_group,
                self.norm_topk_prob) != ("sigmoid", "noaux_tc", 1, 1, True):
            raise NotImplementedError("only sigmoid noaux_tc routing over one group, the "
                                      "picked scores normalised, is built")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def experts_held(self) -> int:
        return self.n_routed_experts if self.held_experts is None else self.held_experts

    @classmethod
    def from_dict(cls, d: dict) -> "KimiVLConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class RMSNorm(nn.Module):
    """``w * x / sqrt(mean(x^2) + eps)`` (``F.rms_norm``: the mean and the
    product in float32, one rounding to x's dtype)."""

    def __init__(self, dim: int, eps: float, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, (x.shape[-1],), self.weight, self.eps)


def rope_angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """The complex rotations e^(i position theta^(-2k/dim)), k < dim / 2, of
    shape positions.shape + (dim / 2,)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=positions.device,
                                        dtype=torch.float32) / dim))
    freqs = positions.float()[..., None] * inv
    return torch.polar(torch.ones_like(freqs), freqs)


def apply_rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """``x`` (..., dim) in the projection's interleaved order, rotated
    (module doc): pair k as a complex number times ``rot[..., k]``, its real
    part to k and its imaginary part to k + dim / 2; ``rot`` broadcasts
    against the pairs."""
    pairs = torch.view_as_complex(x.float().unflatten(-1, (x.shape[-1] // 2, 2)))
    return torch.view_as_real(pairs * rot).transpose(-1, -2).flatten(-2).to(x.dtype)


class SwiGLU(nn.Module):
    def __init__(self, hidden: int, width: int, dtype):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, width, bias=False, dtype=dtype)
        self.up_proj = nn.Linear(hidden, width, bias=False, dtype=dtype)
        self.down_proj = nn.Linear(width, hidden, bias=False, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class Gate(nn.Module):
    """The router: ``weight`` (E, hidden) and the correction bias, which
    moves the choice of experts and not their weights; both held in
    float32, the router's precision."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(cfg.n_routed_experts),
                                                    requires_grad=False)


class Experts(nn.Module):
    """The held routed experts stacked for the grouped GEMMs."""

    def __init__(self, cfg: KimiVLConfig, dtype):
        super().__init__()
        e, h, i = cfg.experts_held, cfg.hidden_size, cfg.moe_intermediate_size
        self.gate_up_proj = nn.Parameter(torch.empty(e, 2 * i, h, dtype=dtype))
        self.down_proj = nn.Parameter(torch.empty(e, h, i, dtype=dtype))


class MoE(nn.Module):
    def __init__(self, cfg: KimiVLConfig, dtype):
        super().__init__()
        self.cfg = cfg
        self.gate = Gate(cfg)
        self.experts = Experts(cfg, dtype)
        self.shared_experts = SwiGLU(cfg.hidden_size,
                                     cfg.moe_intermediate_size * cfg.n_shared_experts, dtype)

    def forward(self, h: torch.Tensor, hits: Optional[torch.Tensor] = None,
                pairs: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        flat = h.reshape(-1, h.shape[-1])
        out = moe.moe_forward(flat, self.gate.weight, self.gate.e_score_correction_bias,
                              self.experts.gate_up_proj, self.experts.down_proj,
                              top_k=c.num_experts_per_tok, scale=c.routed_scaling_factor,
                              hits=hits, first=c.expert_offset, pairs=pairs)
        return (out + self.shared_experts(flat)).reshape(h.shape)


class Attention(nn.Module):
    """Multi-head latent attention (module doc). With ``mla_use_nope``
    (Kimi-Linear's MLA layers) ``q_pe`` and ``k_pe`` enter unrotated: the
    scale stays 1 / sqrt(nope + rope), the latent holds the unrotated
    ``k_pe``, and ``rot`` is not read (None will do)."""

    def __init__(self, cfg: KimiVLConfig, dtype):
        super().__init__()
        self.cfg = cfg
        h, n = cfg.hidden_size, cfg.num_attention_heads
        self.heads = n
        self.q_proj = nn.Linear(h, n * cfg.qk_head_dim, bias=False, dtype=dtype)
        self.kv_a_proj_with_mqa = nn.Linear(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                                            bias=False, dtype=dtype)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps, dtype)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank,
                                   n * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False,
                                   dtype=dtype)
        self.o_proj = nn.Linear(n * cfg.v_head_dim, h, bias=False, dtype=dtype)
        self.scale = 1.0 / math.sqrt(cfg.qk_head_dim)

    def queries(self, h, rot) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q_nope (..., H, nope), q_pe (..., H, rope), rotated) of rows ``h``
        (..., hidden) at the rotations ``rot`` (..., rope / 2)."""
        c = self.cfg
        q = self.q_proj(h).unflatten(-1, (self.heads, c.qk_head_dim))
        q_nope, q_pe = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], dim=-1)
        if c.mla_use_nope:
            return q_nope, q_pe
        return q_nope, apply_rope(q_pe, rot[..., None, :])

    def latent(self, h, rot) -> torch.Tensor:
        """(..., rank + rope): the normalised ``c`` and the rotated ``k_pe``
        of rows ``h`` (..., hidden), what the cache holds."""
        c = self.cfg
        c_kv, k_pe = self.kv_a_proj_with_mqa(h).split([c.kv_lora_rank, c.qk_rope_head_dim], -1)
        if not c.mla_use_nope:
            k_pe = apply_rope(k_pe, rot)
        return torch.cat([self.kv_a_layernorm(c_kv), k_pe], dim=-1)

    def _kv_b(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """W_UK (H, nope, rank) and W_UV (H, v, rank), views of ``kv_b_proj``."""
        c = self.cfg
        w = self.kv_b_proj.weight.unflatten(0, (self.heads, c.qk_nope_head_dim + c.v_head_dim))
        return w[:, : c.qk_nope_head_dim], w[:, c.qk_nope_head_dim:]

    def attend(self, q_nope, q_pe, latent, mask) -> torch.Tensor:
        """The plain form over a whole sequence: keys and values from the
        latent through ``kv_b_proj``; ``mask`` (B, 1, S, S) bool, True where
        a query sees a key, or None: causal. Returns the o_proj output (B, S,
        hidden)."""
        c = self.cfg
        b, s = latent.shape[:2]
        c_kv, k_pe = latent.split([c.kv_lora_rank, c.qk_rope_head_dim], dim=-1)
        kv = self.kv_b_proj(c_kv).unflatten(-1, (self.heads, c.qk_nope_head_dim + c.v_head_dim))
        k_nope, v = kv.split([c.qk_nope_head_dim, c.v_head_dim], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(b, s, self.heads, -1)],
                      dim=-1).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, v.transpose(1, 2), attn_mask=mask,
                                           is_causal=mask is None, scale=self.scale)
        return self.o_proj(o.transpose(1, 2).flatten(2))

    def attend_absorbed(self, q_nope, q_pe, latent, bias) -> torch.Tensor:
        """One query a row against cached latent rows: W_UK absorbed into
        the query, the softmax over the latent slots, W_UV after it.
        ``q_nope`` (B, H, nope), ``q_pe`` (B, H, rope), ``latent`` (B, T,
        rank + rope), ``bias`` (B, 1, T) float32 additive. Returns the
        o_proj output (B, hidden)."""
        c = self.cfg
        w_uk, w_uv = self._kv_b()
        q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)  # (B, H, rank)
        q = torch.cat([q_lat, q_pe], dim=-1)  # (B, H, rank + rope)
        scores = torch.bmm(q, latent.transpose(1, 2)).float() * self.scale + bias
        probs = torch.softmax(scores, dim=-1).to(latent.dtype)
        o_lat = torch.bmm(probs, latent[..., : c.kv_lora_rank])  # (B, H, rank)
        o = torch.bmm(o_lat.transpose(0, 1), w_uv.transpose(1, 2)).transpose(0, 1)  # (B, H, v)
        return self.o_proj(o.flatten(1))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: KimiVLConfig, index: int, dtype):
        super().__init__()
        self.self_attn = Attention(cfg, dtype)
        self.dense = index < cfg.first_k_dense_replace
        self.mlp = (SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype) if self.dense
                    else MoE(cfg, dtype))
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)

    def feed_forward(self, x: torch.Tensor, hits: Optional[torch.Tensor] = None,
                     pairs: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.post_attention_layernorm(x)
        return x + (self.mlp(h) if self.dense else self.mlp(h, hits, pairs))

    def forward(self, x, rot, mask, hits: Optional[torch.Tensor] = None):
        """The plain form over whole sequences ``x`` (B, S, hidden): (x after
        the layer, the layer's latent rows (B, S, rank + rope))."""
        attn = self.self_attn
        h = self.input_layernorm(x)
        q_nope, q_pe = attn.queries(h, rot)
        lat = attn.latent(h, rot)
        return self.feed_forward(x + attn.attend(q_nope, q_pe, lat, mask), hits), lat


class TextModel(nn.Module):
    def __init__(self, cfg: KimiVLConfig, dtype):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)


class LanguageModel(nn.Module):
    def __init__(self, cfg: KimiVLConfig, dtype):
        super().__init__()
        self.model = TextModel(cfg, dtype)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype)


class KimiVLForCausalLM(nn.Module):
    """The language model under the published ``language_model.`` prefix.
    ``latent_cache`` tells ``tasks/decode_cache.py::greedy_decode_cached``
    to decode it with ``tasks/decode_latent.py``."""

    latent_cache = True

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        self.language_model = LanguageModel(cfg, DTYPES[cfg.dtype])

    @property
    def layers(self):
        return self.language_model.model.layers

    @property
    def latent_layers(self) -> int:
        """Layers whose latent rows the decode cache holds: every one."""
        return self.cfg.num_hidden_layers

    def embed(self, input_ids: torch.Tensor, image_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """Token embeddings with the image rows in the placeholders' places."""
        x = self.language_model.model.embed_tokens(input_ids)
        if image_embeds is not None:
            slots = (input_ids == self.cfg.media_placeholder_token_id)[..., None]
            x = x.masked_scatter(slots, image_embeds.to(x.dtype))
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """float32 logits of residual rows ``x``."""
        lm = self.language_model
        return lm.lm_head(lm.model.norm(x)).float()

    def positions(self, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, S) positions counted from each left-padded row's first token."""
        return (attention_mask.long().cumsum(dim=1) - 1).clamp(min=0)

    def causal_mask(self, attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, 1, S, S) bool: a query sees the valid keys up to itself; a pad
        query sees itself alone."""
        s, dev = attention_mask.shape[1], attention_mask.device
        idx = torch.arange(s, device=dev)
        causal = idx[None, :] <= idx[:, None]
        eye = torch.eye(s, dtype=torch.bool, device=dev)
        return ((causal[None] & attention_mask.bool()[:, None, :]) | eye)[:, None]

    def rope(self, positions: torch.Tensor):
        return rope_angles(positions, self.cfg.qk_rope_head_dim, self.cfg.rope_theta)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S, vocab) float32 logits of every position (the plain form)."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        return self.logits(self.run(self.embed(input_ids, image_embeds), attention_mask))

    def run(self, x: torch.Tensor, attention_mask: torch.Tensor, sink=None,
            hits: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every layer in the plain form over embedded, left-padded prompts
        ``x`` (B, S, hidden): the final residual. ``sink(layer, latent)``
        receives each layer's latent rows (B, S, rank + rope); ``hits`` goes
        to the MoE layers."""
        rot, mask = self.rope(self.positions(attention_mask)), self.causal_mask(attention_mask)
        for i, layer in enumerate(self.layers):
            x, lat = layer(x, rot, mask, hits)
            if sink is not None:
                sink(i, lat)
        return x


# -- the published checkpoint's names ---------------------------------------

_EXPERT = re.compile(r"^(.*\.mlp\.experts)\.(\d+)\.(gate_proj|up_proj|down_proj)\.weight$")


def stacked_key(name: str, moe_width: int):
    """(state-dict key, index) where the published tensor ``name`` lives:
    a per-expert ``…mlp.experts.E.{gate,up,down}_proj.weight`` lands in the
    stacked ``gate_up_proj[E, :width]`` / ``gate_up_proj[E, width:]`` /
    ``down_proj[E]``; every other name is its own key, index ``None``."""
    m = _EXPERT.match(name)
    if m is None:
        return name, None
    prefix, e, kind = m.group(1), int(m.group(2)), m.group(3)
    if kind == "down_proj":
        return f"{prefix}.down_proj", (e,)
    rows = slice(0, moe_width) if kind == "gate_proj" else slice(moe_width, 2 * moe_width)
    return f"{prefix}.gate_up_proj", (e, rows)


@torch.no_grad()
def load_published(model: KimiVLForCausalLM, tensors: Iterable[Tuple[str, torch.Tensor]]) -> int:
    """Copy each (published name, tensor) into ``model``'s parameters in
    place, cast to each parameter's dtype; returns the count. Keys the model
    lacks raise ``KeyError``."""
    params = dict(model.named_parameters())
    n = 0
    for name, t in tensors:
        key, index = stacked_key(name, model.cfg.moe_intermediate_size)
        dst = params[key] if index is None else params[key][index]
        dst.copy_(t)
        n += 1
    return n
