"""Cached greedy decoding over a latent KV cache: Kimi-VL's language model
(``models/kimi_vl.py``), whose multi-head latent attention caches one
latent row a token and layer that every head shares.

The cache is one buffer of shape (layers, B, T, rank + rope), T = P + N -
1 rounded up to ``KEY_ALIGN``: slots [0, P) hold the left-padded prompt,
slot P + j the token that step j feeds. A row's latent is ``[c | k_pe]``,
the normalised 512-d ``c`` and the rotated 64-d ``k_pe``. The buffer is
written slot by slot in place (as ``tasks/decode_cache.py``'s head-major
K/V buffers) and kept from batch to batch of one shape: a slot not yet
written holds zeros or an earlier batch's finite rows, which the bias
masks. Nothing is concatenated or copied.

Prefill runs the plain (unabsorbed) form of ``models/kimi_vl.py`` over the
prompts, ``PREFILL_ROWS`` rows at a time (the transient MoE rows of a
chunk, not of the batch, are held at once), writes every prompt slot's
latent, and emits the first token from the last prompt position (the
prompts are left-padded, so it is every row's last).

Step j feeds that token at slot P + j, at position ``lengths + j`` (each
row's positions count from its own first token), one query a row:

  * ``W_UK`` absorbed into the query: (B, 16, 512) plus the rotated
    ``q_pe``, (B, 16, 576) against the latent slots [0, P + j] rounded up
    to ``KEY_ALIGN`` slots (so the GEMMs' operands stay aligned);
  * the softmax in float32 under an additive bias built on the device from
    each row's first slot (``start``): a left pad and a slot past P + j add
    -inf; a row always sees its own slot;
  * ``W_UV`` per head on the attention-weighted latent, then ``o_proj``;
  * the MoE (``ops/moe.py``), the next layer; then the head. The next token
    is the greedy arg-max of the float32 logits; its log-probability is
    kept.

No step reads anything back to the host: the token, the positions, the
slot and the bias come from tensors on the device; the host's loop counter
sets only how many slots a step reads. So on the card the steps run as CUDA
graphs (``StepGraphs``): one graph a key count, captured at a batch shape's
first call and replayed with the step index in a device tensor; the host
issues one replay a step instead of ~2,400 operator calls. A model keeps the
graphs of one batch shape: a batch of another shape frees them (with their
latent buffer) and captures its own. Elsewhere (the
CPU tests) the same step runs eagerly.

``tasks/decode_hybrid.py`` (Kimi-Linear) keeps this cache for its MLA
layers and reuses ``GreedyState`` and ``StepGraphs``.

Spans (``utils/profiling.py``): ``decode.cached`` around a batch,
``decode.prefill``, ``decode.step`` (the eager step, or a replay): the
names and roles of the BertImg decoder's. Counters: ``decode.latent_bytes``,
the latent bytes a step's attention reads (from shapes);
``moe.routed_tokens`` (a replay counts its MoE calls' pairs);
``moe.experts_hit``, the experts that at least one token chose, summed over
the cached steps' MoE calls, accumulated on the device and read once a
batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from aladin_torch.models.kimi_vl import DTYPES, KimiVLForCausalLM
from aladin_torch.utils import profiling
from aladin_torch.utils.device import graph_capture

PREFILL_ROWS = 64  # prompts a prefill chunk
KEY_ALIGN = 16  # a step reads the latent slots in multiples of this: aligned GEMM operands


class LatentCache(NamedTuple):
    latent: torch.Tensor  # (layers, B, T, rank + rope)
    start: torch.Tensor  # (B,) slot of each row's first token
    lengths: torch.Tensor  # (B,) a row's prompt tokens
    slots: torch.Tensor  # (T,) slot indices
    prompt: int  # P


def cache_slots(prompt: int, max_new: int) -> int:
    """T: the prompt and the fed tokens' slots, rounded up to ``KEY_ALIGN``."""
    return -(-(prompt + max_new - 1) // KEY_ALIGN) * KEY_ALIGN


def step_keys(cache: LatentCache, j: int) -> int:
    """The latent slots step ``j`` reads: [0, P + j] rounded up."""
    return min(-(-(cache.prompt + j + 1) // KEY_ALIGN) * KEY_ALIGN, cache.latent.shape[2])


def count_latent_bytes(cache: LatentCache, keys: int) -> None:
    lat = cache.latent
    profiling.count("decode.latent_bytes",
                    lat.shape[0] * lat.shape[1] * keys * lat.shape[3] * lat.element_size())


@torch.no_grad()
def prefill(model: KimiVLForCausalLM, input_ids: torch.Tensor, image_embeds: Optional[torch.Tensor],
            attention_mask: torch.Tensor, max_new: int,
            latent: Optional[torch.Tensor] = None) -> Tuple[LatentCache, torch.Tensor]:
    """(the cache with every prompt slot written, the (B, vocab) float32
    logits of the last prompt position). ``latent``: a buffer of the cache's
    shape to write into (its step slots need not be clear: a step writes its
    slot before any step reads it), else a zeroed one."""
    with profiling.span("decode.prefill"):
        model.eval()
        cfg = model.cfg
        b, p = input_ids.shape
        dev = input_ids.device
        x_all = model.embed(input_ids, image_embeds)
        if latent is None:
            latent = torch.zeros(cfg.num_hidden_layers, b, cache_slots(p, max_new),
                                 cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype=x_all.dtype,
                                 device=dev)
        last = []
        for lo in range(0, b, PREFILL_ROWS):
            rows = slice(lo, min(lo + PREFILL_ROWS, b))

            def sink(i, lat, rows=rows):
                latent[i, rows, :p] = lat

            x = model.run(x_all[rows], attention_mask[rows], sink)
            last.append(x[:, -1])
        lengths = attention_mask.long().sum(dim=1)
        cache = LatentCache(latent, p - lengths, lengths,
                            torch.arange(latent.shape[2], device=dev), p)
        return cache, model.logits(torch.cat(last))


@torch.no_grad()
def decode_step(model: KimiVLForCausalLM, cache: LatentCache, prev_tok: torch.Tensor, j: int,
                hits: Optional[torch.Tensor] = None,
                j_dev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Step ``j``: feed ``prev_tok`` (B,) at slot P + j and return the
    (B, vocab) float32 logits of the next token. The host's ``j`` sets only
    how many slots the step reads (``step_keys``); the slot, the positions
    and the mask come from ``j_dev`` (a one-element int64 tensor on the
    device, made from ``j`` if not given), so one CUDA graph serves every
    step of a key count."""
    with profiling.span("decode.step"):
        lat = cache.latent
        keys = step_keys(cache, j)
        if j_dev is None:
            j_dev = torch.full((1,), j, dtype=torch.long, device=prev_tok.device)
        slot = cache.prompt + j_dev  # (1,)
        rot = model.rope(cache.lengths + j_dev)  # (B, rope / 2)
        x = model.language_model.model.embed_tokens(prev_tok)  # (B, hidden): one token a row
        seen = cache.slots[None, :keys]
        bias = torch.where((seen >= cache.start[:, None]) & (seen <= slot), 0.0,
                           float("-inf"))[:, None]  # (B, 1, keys)
        if not (lat.is_cuda and torch.cuda.is_current_stream_capturing()):
            count_latent_bytes(cache, keys)  # a graph's replays count their own
        for i, layer in enumerate(model.layers):
            attn = layer.self_attn
            h = layer.input_layernorm(x)
            q_nope, q_pe = attn.queries(h, rot)
            lat[i].index_copy_(1, slot, attn.latent(h, rot)[:, None])
            x = x + attn.attend_absorbed(q_nope, q_pe, lat[i, :, :keys], bias)
            x = layer.feed_forward(x, hits)
        return model.logits(x)


class GreedyState:
    """What a greedy decode of one batch shape holds on the device: the
    latent buffer, each row's first slot and prompt length, the token fed
    next, the tokens and summed log-probabilities so far, the experts hit,
    and the step index."""

    def __init__(self, model: KimiVLForCausalLM, b: int, p: int, max_new: int, device):
        cfg = model.cfg
        dtype = DTYPES[cfg.dtype]
        self.cache = LatentCache(
            torch.zeros(model.latent_layers, b, cache_slots(p, max_new),
                        cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype=dtype, device=device),
            torch.zeros(b, dtype=torch.long, device=device),
            torch.zeros(b, dtype=torch.long, device=device),
            torch.arange(cache_slots(p, max_new), device=device), p)
        self.tok = torch.zeros(b, dtype=torch.long, device=device)
        self.tokens = torch.zeros(b, max_new, dtype=torch.long, device=device)
        self.logprob = torch.zeros(b, device=device)
        self.hits = torch.zeros((), dtype=torch.int64, device=device)
        self.j = torch.zeros(1, dtype=torch.long, device=device)

    def start(self, cache: LatentCache, logits: torch.Tensor) -> None:
        """Take a prefill's cache rows and its logits, the first token."""
        self.cache.start.copy_(cache.start)
        self.cache.lengths.copy_(cache.lengths)
        logp = F.log_softmax(logits, dim=-1)
        self.tok.copy_(logp.argmax(dim=-1))
        self.logprob.copy_(logp.gather(1, self.tok[:, None])[:, 0])
        self.tokens[:, 0] = self.tok
        self.hits.zero_()

    def logits(self, model: KimiVLForCausalLM, j: int) -> torch.Tensor:
        """The (B, vocab) float32 logits of step ``j``, fed ``self.tok``."""
        return decode_step(model, self.cache, self.tok, j, self.hits, self.j)

    def step(self, model: KimiVLForCausalLM, j: int) -> None:
        """Step ``j`` (``self.j`` holds it on the device) and the greedy
        choice: the next token, its log-probability, the token's column."""
        logp = F.log_softmax(self.logits(model, j), dim=-1)
        tok = logp.argmax(dim=-1)
        self.logprob += logp.gather(1, tok[:, None])[:, 0]
        self.tokens.index_copy_(1, self.j + 1, tok[:, None])
        self.tok.copy_(tok)


_SIDE_STREAMS = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream a device for every capture: each new stream would
    get (and keep) its own cuBLAS workspace."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
    return _SIDE_STREAMS[device]


class StepGraphs:
    """CUDA graphs of ``GreedyState.step`` at one batch shape: one graph a
    key count (``step_keys`` changes every ``KEY_ALIGN`` steps), all in one
    memory pool, each captured on the device's one side stream after one
    eager run there. A replay reads the step index from ``state.j``."""

    def __init__(self, model: KimiVLForCausalLM, state: GreedyState, max_new: int):
        self.state = state
        self.graphs = {}
        pool = torch.cuda.graph_pool_handle()
        side = _side_stream(state.cache.latent.device)
        for j in range(max_new - 1):
            keys = step_keys(state.cache, j)
            if keys in self.graphs:
                continue
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                state.step(model, j)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with graph_capture(graph, pool=pool, stream=side):
                state.step(model, j)
            self.graphs[keys] = graph

    def replay(self, j: int) -> None:
        self.graphs[step_keys(self.state.cache, j)].replay()


def _graphed(model: KimiVLForCausalLM, b: int, p: int, max_new: int, device,
             state_cls: type = GreedyState) -> StepGraphs:
    """The model's step graphs for this batch shape, over a ``state_cls``
    state (``tasks/decode_hybrid.py`` passes its own). A model holds one
    set: a new shape releases the old set (``release_graphs``) before its
    own is captured."""
    key = (b, p, max_new)
    held = model.__dict__.get("_step_graphs")
    if held is not None and held[0] == key:
        return held[1]
    release_graphs(model)
    graphs = StepGraphs(model, state_cls(model, b, p, max_new, device), max_new)
    model.__dict__["_step_graphs"] = (key, graphs)
    return graphs


def release_graphs(model: KimiVLForCausalLM) -> None:
    """Drop the model's step graphs, their memory pool and their decode
    state (the latent buffer); the next batch captures anew."""
    if model.__dict__.pop("_step_graphs", None) is not None:
        torch.cuda.synchronize()


@torch.no_grad()
def greedy_decode(model: KimiVLForCausalLM, input_ids: torch.Tensor,
                  image_embeds: Optional[torch.Tensor], attention_mask: torch.Tensor, *,
                  max_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens (B, max_steps) int64, summed log-probabilities (B,) float32)
    of greedy decoding ``max_steps`` new tokens, with no early stop. On the
    card the cached steps replay CUDA graphs (``StepGraphs``, captured at a
    batch shape's first call); elsewhere they run eagerly."""
    with profiling.span("decode.cached"):
        b, p = input_ids.shape
        dev = input_ids.device
        graphs = _graphed(model, b, p, max_steps, dev) if dev.type == "cuda" else None
        state = graphs.state if graphs is not None else GreedyState(model, b, p, max_steps, dev)
        cache, logits = prefill(model, input_ids, image_embeds, attention_mask, max_steps,
                                latent=state.cache.latent)
        state.start(cache, logits)
        moe_calls = model.cfg.num_hidden_layers - model.cfg.first_k_dense_replace
        for j in range(max_steps - 1):
            if graphs is None:
                state.j.fill_(j)
                state.step(model, j)
                continue
            with profiling.span("decode.step"):
                state.j.fill_(j)
                graphs.replay(j)
                count_latent_bytes(state.cache, step_keys(state.cache, j))
                profiling.count("moe.routed_tokens", moe_calls * b * model.cfg.num_experts_per_tok)
        profiling.count("moe.experts_hit", int(state.hits))
        return state.tokens.clone(), state.logprob.clone()
