"""Kimi-Linear-48B-A3B-Instruct (moonshotai/Kimi-Linear-48B-A3B-Instruct,
``config.json``; the Kimi Linear technical report, arXiv 2510.26692): 27
layers at hidden 2304, Kimi Delta Attention (KDA) in 20 of them and
multi-head latent attention without rotation (``mla_use_nope``) in the
other 7, every feed-forward but layer 0's a 256-expert MoE; causal, in the
configuration's dtype.

The config's ``linear_attn_config`` counts layers from 1: 0-based, layers
3, 7, 11, 15, 19, 23 and 26 are MLA and every other layer is KDA.

A KDA layer, per token t and head n (32 heads, d_k = d_v = 128), ``x``
the residual stream:

  * ``h = RMSNorm_in(x)``;
  * ``q, k, v = SiLU(Conv(W_{q,k,v} h))``, each W 2304 -> 4096, each Conv
    causal and depthwise with a width-4 kernel and no bias, from zeros at a
    document's first token;
  * ``q <- q / |q| / sqrt(128)``, ``k <- k / |k|`` per head, with
    ``|x| = sqrt(sum x^2 + 1e-6)``;
  * ``log alpha_t = -exp(A_log[n]) softplus(W_fb W_fa h + dt_bias)``, a
    128-vector a head, in float32 (``W_fa`` 2304 -> 128, ``W_fb`` 128 ->
    4096, ``dt_bias`` 4096 entries, ``A_log`` 32);
  * ``beta_t = sigmoid(W_b h)[n]`` (``W_b`` 2304 -> 32);
  * in float32, with S (128 x 128) zero at a document's start:
    ``S <- Diag(alpha_t) S``; ``S <- S + beta_t k_t (v_t - S^T k_t)^T``;
    ``o_t = S^T q_t``;
  * ``o <- RMSNorm_head(o) * sigmoid(W_gb W_ga h + b_g)``, the norm over
    each head's 128 values with one 128-weight shared by the heads and eps
    1e-5, ``W_ga`` 2304 -> 128, ``W_gb`` 128 -> 4096 with its bias ``b_g``;
  * ``x += W_o o`` (4096 -> 2304).

Assumed, since the catalog's config does not give them: the low-rank gate
widths (128), the gated output norm and ``b_g``, as in the reference KDA
layer of the ``fla`` library (``fla/layers/kda.py``); ``A_log`` and
``dt_bias`` held in float32, as ``fla`` holds them.

An MLA layer is ``models/kimi_vl.py``'s ``Attention`` with
``mla_use_nope``: 32 heads, ``kv_lora_rank`` 512, nope 128, rope 64 (not
rotated), v 128, no low-rank query, scale 1 / sqrt(192). The feed-forward
of every layer is Kimi-VL's: ``h = RMSNorm_post(x)``; layer 0 a dense
SwiGLU of width 9216; layers 1-26 the MoE of ``ops/moe.py`` (256 router
outputs, sigmoid scores, top-8 of scores plus the correction bias, the
picked scores renormalised and scaled by 2.446, experts of width 1024) plus
one shared expert of width 1024. Then the final RMSNorm and the untied head
over 163,840 words.

Held experts: a card of an expert-parallel deployment holds ``num_experts``
of the router's ``router_experts`` from ``expert_offset``; the router ranks
all of them and the layer adds its own experts' part of the routed sum
(``ops/moe.py``). With ``router_experts`` left out every expert is held.

Documents are packed end to end, with no pad token (``Pack``): ``run``
takes the residual rows of the packed tokens. A KDA layer runs its
recurrence through ``ops/kernels/kda.py`` (K5 on the card), which writes
each document's final state and convolution tails into the decode cache's
buffers; an MLA layer hands its latent rows to ``sink`` and attends
document by document (one causal SDPA call a document, keys from the
document's own latent rows: no mask tensor is built, and on the card the
SDPA is held to its fused kernels, never the math path). The feed-forward
and the KDA output stage run over ``PREFILL_ROWS`` rows at a time, which
bounds their transients.

State-dict keys are the port's: ``model.layers.N.self_attn.*`` (KDA:
``{q,k,v}_proj``, ``{q,k,v}_conv1d.weight`` (4096, 4), ``f_a_proj``,
``f_b_proj``, ``dt_bias``, ``A_log``, ``b_proj``, ``g_a_proj``,
``g_b_proj`` (with a bias), ``o_norm``, ``o_proj``; MLA: Kimi-VL's names),
``model.layers.N.mlp.*`` (Kimi-VL's, per-expert names stacked by
``kimi_vl.stacked_key``, the expert index counted from 0 over the router's
experts), ``model.embed_tokens``, ``model.norm``, ``lm_head``. A key map
from the published checkpoint's names waits for a checkpoint.

The cached greedy decoder is ``tasks/decode_hybrid.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aladin_torch.models import kimi_vl
from aladin_torch.ops.kernels import kda
from aladin_torch.utils import profiling

PREFILL_ROWS = 16384  # packed rows a feed-forward / KDA output chunk

_LINEAR = {"full_attn_layers": [4, 8, 12, 16, 20, 24, 27],
           "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26],
           "head_dim": 128, "num_heads": 32, "short_conv_kernel_size": 4}


@dataclasses.dataclass
class KimiLinearConfig:
    """The published settings (``config.json``), the experts held here and
    the assumed KDA gate width."""

    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    mla_use_nope: bool = True
    num_experts: int = 256  # held here
    router_experts: Optional[int] = None  # the router's outputs; None: num_experts
    expert_offset: int = 0
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    routed_scaling_factor: float = 2.446
    first_k_dense_replace: int = 1
    moe_renormalize: bool = True
    moe_router_activation_func: str = "sigmoid"
    num_expert_group: int = 1
    topk_group: int = 1
    rms_norm_eps: float = 1e-5
    linear_attn_config: dict = dataclasses.field(default_factory=lambda: dict(_LINEAR))
    kda_gate_rank: int = 128  # assumed (fla/layers/kda.py)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.q_lora_rank is not None or not self.mla_use_nope:
            raise NotImplementedError("only Kimi-Linear's MLA (no low-rank query, no rotation)")
        if (self.moe_router_activation_func, self.num_expert_group, self.topk_group,
                self.moe_renormalize) != ("sigmoid", 1, 1, True):
            raise NotImplementedError("only sigmoid routing over one group, renormalised")
        if self.linear_attn_config["short_conv_kernel_size"] != kda.CONV:
            raise NotImplementedError(f"only width-{kda.CONV} short convolutions")
        if self.router_experts is None:
            self.router_experts = self.num_experts
        if not 0 <= self.expert_offset <= self.router_experts - self.num_experts:
            raise ValueError("the held experts must lie among the router's")

    def is_kda(self, index: int) -> bool:
        """Layer ``index`` (0-based) is KDA; the config counts from 1."""
        return index + 1 in self.linear_attn_config["kda_layers"]

    @property
    def kda_heads(self) -> int:
        return self.linear_attn_config["num_heads"]

    @property
    def kda_head_dim(self) -> int:
        return self.linear_attn_config["head_dim"]

    def mla(self) -> kimi_vl.KimiVLConfig:
        """The settings of the modules shared with Kimi-VL (MLA, the MoE)."""
        return kimi_vl.KimiVLConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            moe_intermediate_size=self.moe_intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            n_shared_experts=self.num_shared_experts, n_routed_experts=self.router_experts,
            routed_scaling_factor=self.routed_scaling_factor, kv_lora_rank=self.kv_lora_rank,
            qk_rope_head_dim=self.qk_rope_head_dim, v_head_dim=self.v_head_dim,
            qk_nope_head_dim=self.qk_nope_head_dim,
            num_experts_per_tok=self.num_experts_per_token,
            first_k_dense_replace=self.first_k_dense_replace, rms_norm_eps=self.rms_norm_eps,
            dtype=self.dtype, mla_use_nope=True, held_experts=self.num_experts,
            expert_offset=self.expert_offset)

    @classmethod
    def from_dict(cls, d: dict) -> "KimiLinearConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class Pack(NamedTuple):
    """Documents packed end to end: ``cu`` (docs + 1,) int32 offsets and
    ``rows`` (docs,) the decode cache's row of each, on the device;
    ``bounds`` the same offsets on the host."""

    cu: torch.Tensor
    rows: torch.Tensor
    bounds: List[int]

    @classmethod
    def of(cls, lengths: Iterable[int], device) -> "Pack":
        bounds = [0]
        for n in lengths:
            bounds.append(bounds[-1] + int(n))
        return cls(torch.tensor(bounds, dtype=torch.int32).to(device),
                   torch.arange(len(bounds) - 1, device=device), bounds)


class _Conv(nn.Module):
    """A short depthwise convolution's kernel (channels, width)."""

    def __init__(self, channels: int, width: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, width, dtype=dtype))


class KDAttention(nn.Module):
    """Kimi Delta Attention (module doc)."""

    def __init__(self, cfg: KimiLinearConfig, dtype):
        super().__init__()
        h, n, dk, r = cfg.hidden_size, cfg.kda_heads, cfg.kda_head_dim, cfg.kda_gate_rank
        d = n * dk
        self.heads, self.head_dim, self.eps = n, dk, cfg.rms_norm_eps
        for name in ("q", "k", "v"):
            setattr(self, f"{name}_proj", nn.Linear(h, d, bias=False, dtype=dtype))
            setattr(self, f"{name}_conv1d", _Conv(d, kda.CONV, dtype))
        self.f_a_proj = nn.Linear(h, r, bias=False, dtype=dtype)
        self.f_b_proj = nn.Linear(r, d, bias=False, dtype=dtype)
        self.dt_bias = nn.Parameter(torch.empty(d))
        self.A_log = nn.Parameter(torch.empty(n))
        self.b_proj = nn.Linear(h, n, bias=False, dtype=dtype)
        self.g_a_proj = nn.Linear(h, r, bias=False, dtype=dtype)
        self.g_b_proj = nn.Linear(r, d, bias=True, dtype=dtype)
        self.o_norm = kimi_vl.RMSNorm(dk, cfg.rms_norm_eps, dtype)
        self.o_proj = nn.Linear(d, h, bias=False, dtype=dtype)

    def weights(self) -> kda.Weights:
        conv = torch.stack([self.q_conv1d.weight, self.k_conv1d.weight, self.v_conv1d.weight])
        return kda.Weights(conv, self.A_log, self.dt_bias)

    def project(self, h: torch.Tensor):
        """The raw inputs of the recurrence for rows ``h`` (N, hidden): q,
        k, v, f (N, 4096) and b (N, 32) (``ops/kernels/kda.py``)."""
        return (self.q_proj(h), self.k_proj(h), self.v_proj(h), self.f_b_proj(self.f_a_proj(h)),
                self.b_proj(h))

    def output(self, o: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The gated head norm and ``o_proj`` of the recurrence's ``o``
        (N, 4096) for rows ``h`` (N, hidden)."""
        gate = torch.sigmoid(self.g_b_proj(self.g_a_proj(h)).float())
        o = F.rms_norm(o.float().unflatten(-1, (self.heads, self.head_dim)), (self.head_dim,),
                       self.o_norm.weight.float(), self.eps)
        return self.o_proj((o.flatten(-2) * gate).to(h.dtype))

    def prefill(self, h: torch.Tensor, pack: Pack, state: torch.Tensor,
                tails: torch.Tensor) -> torch.Tensor:
        """The layer's attention output for packed rows ``h`` (N, hidden);
        each document's final state into ``state[rows]`` (B, 32, 128, 128),
        S transposed,
        and its convolution tails into ``tails[rows]`` (B, 3, 3 x 4096)."""
        q, k, v, f, b = self.project(h)
        with profiling.span("kda.prefill"):
            o = kda.kda_prefill(q, k, v, f, b, self.weights(), pack.cu, pack.rows, state, tails)
        profiling.count("kda.prefill_tokens", h.shape[0])
        del q, k, v, f, b
        out = torch.empty_like(h)
        for lo in range(0, h.shape[0], PREFILL_ROWS):
            rows = slice(lo, lo + PREFILL_ROWS)
            out[rows] = self.output(o[rows], h[rows])
        return out

    def step(self, h: torch.Tensor, state: torch.Tensor, tails: torch.Tensor) -> torch.Tensor:
        """One token a row ``h`` (B, hidden); ``state`` and ``tails`` (the
        rows' own) updated in place."""
        return self.output(kda.kda_step(*self.project(h), self.weights(), state, tails), h)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, index: int, dtype):
        super().__init__()
        shared = cfg.mla()
        self.kda = cfg.is_kda(index)
        self.self_attn = KDAttention(cfg, dtype) if self.kda else kimi_vl.Attention(shared, dtype)
        self.dense = index < cfg.first_k_dense_replace
        self.mlp = (kimi_vl.SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype) if self.dense
                    else kimi_vl.MoE(shared, dtype))
        self.input_layernorm = kimi_vl.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.post_attention_layernorm = kimi_vl.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)

    feed_forward = kimi_vl.DecoderLayer.feed_forward


class TextModel(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, dtype):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = kimi_vl.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)


def _sdpa_kernels(device):
    """On the card, SDPA's fused kernels only: a document of 16 k tokens
    through the math path would build its 32 x 16 k x 16 k scores."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel([SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION])


class KimiLinearForCausalLM(nn.Module):
    """The model under the port's names (module doc). ``hybrid_cache``
    tells ``tasks/decode_cache.py::greedy_decode_cached`` to decode it with
    ``tasks/decode_hybrid.py``."""

    hybrid_cache = True

    def __init__(self, cfg: KimiLinearConfig):
        super().__init__()
        self.cfg = cfg
        dtype = kimi_vl.DTYPES[cfg.dtype]
        self.model = TextModel(cfg, dtype)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype)

    @property
    def layers(self):
        return self.model.layers

    @property
    def embed_tokens(self) -> nn.Embedding:
        return self.model.embed_tokens

    @property
    def latent_layers(self) -> int:
        """The MLA layers, whose latent rows the decode cache holds."""
        return sum(not layer.kda for layer in self.layers)

    @property
    def kda_layers(self) -> int:
        return sum(layer.kda for layer in self.layers)

    def kda_buffers(self, batch: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zeroed (states (KDA layers, B, 32, 128, 128) float32, convolution
        tails (KDA layers, B, 3, 3 x 4096) in the model's dtype)."""
        c = self.cfg
        n, dk = c.kda_heads, c.kda_head_dim
        return (torch.zeros(self.kda_layers, batch, n, dk, dk, device=device),
                torch.zeros(self.kda_layers, batch, kda.CONV - 1, 3 * n * dk,
                            dtype=kimi_vl.DTYPES[c.dtype], device=device))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """float32 logits of residual rows ``x``."""
        return self.lm_head(self.model.norm(x)).float()

    def forward(self, input_ids: torch.Tensor, lengths: Iterable[int]) -> torch.Tensor:
        """(N, vocab) float32 logits of every position of documents packed
        end to end (``input_ids`` (N,), ``lengths`` on the host)."""
        lengths = [int(n) for n in lengths]
        state, tails = self.kda_buffers(len(lengths), input_ids.device)
        pack = Pack.of(lengths, input_ids.device)
        return self.logits(self.run(self.embed_tokens(input_ids), pack, state, tails))

    @torch.no_grad()
    def run(self, x: torch.Tensor, pack: Pack, state: torch.Tensor, tails: torch.Tensor,
            sink: Optional[Callable[[int, torch.Tensor], None]] = None,
            pairs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every layer over packed rows ``x`` (N, hidden), in place: the
        final residual. KDA layer j writes its states and tails into
        ``state[j]`` / ``tails[j]``; ``sink(m, latent)`` receives MLA layer
        m's latent rows (N, rank + rope); ``pairs`` goes to the MoE layers."""
        m = j = 0
        b = pack.bounds
        for layer in self.layers:
            attn = layer.self_attn
            h = layer.input_layernorm(x)
            if layer.kda:
                x += attn.prefill(h, pack, state[j], tails[j])
                j += 1
            else:
                lat = attn.latent(h, None)
                if sink is not None:
                    sink(m, lat)
                m += 1
                with _sdpa_kernels(x.device):
                    for d in range(len(b) - 1):
                        s = slice(b[d], b[d + 1])
                        q_nope, q_pe = attn.queries(h[s], None)
                        x[s] += attn.attend(q_nope[None], q_pe[None], lat[None, s], None)[0]
            del h
            for lo in range(0, x.shape[0], PREFILL_ROWS):
                rows = slice(lo, lo + PREFILL_ROWS)
                x[rows] = layer.feed_forward(x[rows], None, pairs)
        return x


@torch.no_grad()
def load_named(model: KimiLinearForCausalLM, tensors: Iterable[Tuple[str, torch.Tensor]]) -> int:
    """Copy each (name, tensor) into ``model``'s parameters in place, cast
    to each parameter's dtype; a per-expert name (its index over the
    router's experts) lands in the held stack. Returns the count; keys the
    model lacks raise ``KeyError``."""
    params = dict(model.named_parameters())
    first = model.cfg.expert_offset
    n = 0
    for name, t in tensors:
        key, index = kimi_vl.stacked_key(name, model.cfg.moe_intermediate_size)
        dst = params[key]
        if index is not None:
            dst = dst[(index[0] - first,) + index[1:]]
        dst.copy_(t)
        n += 1
    return n
