"""Cached greedy decoding over a hybrid cache: Kimi-Linear
(``models/kimi_linear.py``), whose 7 MLA layers cache a latent row a token
and whose 20 KDA layers carry a fixed-size recurrent state.

One cache holds both kinds of state side by side, all of it allocated once
for a batch shape and kept from batch to batch of that shape:

  * the latent buffer of the MLA layers, ``tasks/decode_latent.py``'s
    (``LatentCache``: (7, B, T, 512 + 64), T = P + N - 1 rounded up to
    ``KEY_ALIGN``, P the longest prompt; a row's prompt lies right-aligned
    in slots [P - length, P), step j's token in slot P + j);
  * the KDA states (20, B, 32, 128, 128) in float32 (each S transposed,
    ``ops/kernels/kda.py``) and the short
    convolutions' tails (20, B, 3, 3 x 4096), the raw q | k | v
    projections of each row's last 3 tokens, in the model's dtype.

Prefill runs the prompts packed end to end (``models/kimi_linear.py::
KimiLinearForCausalLM.run``): no pad token goes through any projection,
convolution, recurrence, attention or expert. It writes every document's
latent rows into its right-aligned slots, its final KDA states and tails
(K5 writes them where it ends each document), and emits the first token
from each document's last position. MLA attention in the prefill runs one
causal SDPA call a document.

Step j feeds the last token at slot P + j, one query a row: an MLA layer as
Kimi-VL's step (``W_UK`` absorbed, the softmax over the slots [0, P + j]
rounded up to ``KEY_ALIGN`` under a bias that masks each row's leading
empty slots; no position enters, there is no rotation); a KDA layer
through K6, which updates the row's state and tails in place. The MoE
(every held expert's part), the head and the greedy choice follow. No step
reads anything back to the host, so on the card the steps replay
``decode_latent.StepGraphs`` (one CUDA graph a key count) over a
``HybridState``, a ``GreedyState`` that also holds the KDA buffers.

Spans (``utils/profiling.py``): ``decode.cached`` around a batch,
``decode.prefill``, ``decode.step``, ``kda.prefill`` (the prefill's K5
calls) and ``moe.*``. Counters: ``decode.prefill_pad_tokens``, the pad
tokens a prefill computes (0: the prompts are packed);
``kda.prefill_tokens`` (``models/kimi_linear.py``); ``kda.state_bytes``,
the state and tail bytes a step reads and writes, and
``decode.latent_bytes``, the latent bytes a step's attention reads (both
from shapes); ``moe.routed_tokens``; ``moe.experts_hit`` (the cached
steps') and ``moe.held_pairs`` (the (token, expert) pairs computed here,
prefill and steps), both summed on the device and read once a batch.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch

from aladin_torch.models.kimi_linear import KimiLinearForCausalLM, Pack
from aladin_torch.tasks import decode_latent as DL
from aladin_torch.utils import profiling


class HybridState(DL.GreedyState):
    """``GreedyState`` (the latent buffer of the MLA layers, the tokens,
    log-probabilities, experts hit and step index) plus the KDA states and
    convolution tails and the held pairs' count."""

    def __init__(self, model: KimiLinearForCausalLM, b: int, p: int, max_new: int, device):
        super().__init__(model, b, p, max_new, device)
        self.kda, self.tails = model.kda_buffers(b, device)
        self.pairs = torch.zeros((), dtype=torch.int64, device=device)

    def logits(self, model: KimiLinearForCausalLM, j: int) -> torch.Tensor:
        return decode_step(model, self, self.tok, j, self.hits, self.j, self.pairs)


def count_state_bytes(state: HybridState) -> None:
    """A step reads and writes every KDA state and tail once."""
    profiling.count("kda.state_bytes", 2 * (state.kda.numel() * state.kda.element_size()
                                            + state.tails.numel() * state.tails.element_size()))


@torch.no_grad()
def prefill(model: KimiLinearForCausalLM, input_ids: torch.Tensor, lengths: Sequence[int],
            state: HybridState) -> torch.Tensor:
    """Run the packed prompts ``input_ids`` (N,) of ``lengths`` (host) into
    ``state``'s cache (module doc); returns the (B, vocab) float32 logits
    of each prompt's last position."""
    with profiling.span("decode.prefill"):
        model.eval()
        dev = input_ids.device
        cache = state.cache
        p = cache.prompt
        pack = Pack.of(lengths, dev)
        profiling.count("decode.prefill_pad_tokens", input_ids.shape[0] - pack.bounds[-1])
        lens = torch.as_tensor(list(lengths), device=dev)
        starts = p - lens
        row = torch.repeat_interleave(pack.rows, lens)
        slot = (torch.arange(input_ids.shape[0], device=dev)
                - torch.repeat_interleave(pack.cu[:-1].long(), lens) + starts[row])

        def sink(m, lat):
            cache.latent[m].index_put_((row, slot), lat)

        x = model.run(model.embed_tokens(input_ids), pack, state.kda, state.tails, sink,
                      state.pairs)
        cache.start.copy_(starts)
        cache.lengths.copy_(lens)
        return model.logits(x[pack.cu[1:].long() - 1])


@torch.no_grad()
def decode_step(model: KimiLinearForCausalLM, state: HybridState, prev_tok: torch.Tensor, j: int,
                hits: Optional[torch.Tensor] = None, j_dev: Optional[torch.Tensor] = None,
                pairs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Step ``j``: feed ``prev_tok`` (B,) at slot P + j and return the
    (B, vocab) float32 logits of the next token; the KDA states and tails
    move on in place. The host's ``j`` sets only how many latent slots the
    step reads; the slot comes from ``j_dev`` (as ``decode_latent.
    decode_step``'s)."""
    with profiling.span("decode.step"):
        cache = state.cache
        lat = cache.latent
        keys = DL.step_keys(cache, j)
        if j_dev is None:
            j_dev = torch.full((1,), j, dtype=torch.long, device=prev_tok.device)
        slot = cache.prompt + j_dev  # (1,)
        x = model.embed_tokens(prev_tok)  # (B, hidden)
        seen = cache.slots[None, :keys]
        bias = torch.where((seen >= cache.start[:, None]) & (seen <= slot), 0.0,
                           float("-inf"))[:, None]  # (B, 1, keys)
        if not (lat.is_cuda and torch.cuda.is_current_stream_capturing()):
            DL.count_latent_bytes(cache, keys)  # a graph's replays count their own
            count_state_bytes(state)
        m = k = 0
        for layer in model.layers:
            attn = layer.self_attn
            h = layer.input_layernorm(x)
            if layer.kda:
                x = x + attn.step(h, state.kda[k], state.tails[k])
                k += 1
            else:
                q_nope, q_pe = attn.queries(h, None)
                lat[m].index_copy_(1, slot, attn.latent(h, None)[:, None])
                x = x + attn.attend_absorbed(q_nope, q_pe, lat[m, :, :keys], bias)
                m += 1
            x = layer.feed_forward(x, hits, pairs)
        return model.logits(x)


def _eager_state(model: KimiLinearForCausalLM, b: int, p: int, max_new: int,
                 device) -> HybridState:
    """Off the card, the model keeps one batch shape's state as the card
    keeps its graphs' (``decode_latent._graphed``)."""
    key = (b, p, max_new)
    held = model.__dict__.get("_eager_state")
    if held is None or held[0] != key:
        held = (key, HybridState(model, b, p, max_new, device))
        model.__dict__["_eager_state"] = held
    return held[1]


def held_state(model: KimiLinearForCausalLM) -> HybridState:
    """The state that decoded the model's last batch (its KDA states and
    tails after the last step): its step graphs' on the card, else the
    eager one."""
    if "_step_graphs" in model.__dict__:
        return model.__dict__["_step_graphs"][1].state
    return model.__dict__["_eager_state"][1]


@torch.no_grad()
def capture_steps(model: KimiLinearForCausalLM, lengths: Iterable[int], max_steps: int,
                  device) -> None:
    """On the card, capture the step graphs of a batch of ``lengths``
    prompts before its first batch, as a server warms up; ``greedy_decode``
    then replays them. Elsewhere nothing is captured."""
    lengths = [int(n) for n in lengths]
    if torch.device(device).type == "cuda":
        DL._graphed(model, len(lengths), max(lengths), max_steps, device, HybridState)


@torch.no_grad()
def greedy_decode(model: KimiLinearForCausalLM, input_ids: torch.Tensor, lengths: Iterable[int],
                  *, max_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens (B, max_steps) int64, summed log-probabilities (B,) float32)
    of greedy decoding ``max_steps`` new tokens after each of the packed
    prompts ``input_ids`` (N,) of ``lengths`` (host integers), with no
    early stop. On the card the cached steps replay CUDA graphs captured at
    a batch shape's first call; elsewhere they run eagerly."""
    with profiling.span("decode.cached"):
        lengths = [int(n) for n in lengths]
        b, p = len(lengths), max(lengths)
        dev = input_ids.device
        if dev.type == "cuda":
            graphs = DL._graphed(model, b, p, max_steps, dev, HybridState)
            state = graphs.state
        else:
            graphs, state = None, _eager_state(model, b, p, max_steps, dev)
        state.pairs.zero_()
        logits = prefill(model, input_ids, lengths, state)
        state.start(state.cache, logits)
        moe_calls = model.cfg.num_hidden_layers - model.cfg.first_k_dense_replace
        for j in range(max_steps - 1):
            if graphs is None:
                state.j.fill_(j)
                state.step(model, j)
                continue
            with profiling.span("decode.step"):
                state.j.fill_(j)
                graphs.replay(j)
                DL.count_latent_bytes(state.cache, DL.step_keys(state.cache, j))
                count_state_bytes(state)
                profiling.count("moe.routed_tokens",
                                moe_calls * b * model.cfg.num_experts_per_token)
                profiling.count("k6.launches", model.kda_layers)
        hits, pairs = torch.stack([state.hits, state.pairs]).tolist()
        profiling.count("moe.experts_hit", hits)
        profiling.count("moe.held_pairs", pairs)
        return state.tokens.clone(), state.logprob.clone()
