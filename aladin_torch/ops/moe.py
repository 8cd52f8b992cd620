"""Routed experts: the sigmoid router with a correction bias, the dispatch
of tokens to stacked experts through grouped GEMMs, and the combine.

``route``: scores ``s = sigmoid(W_r h)`` in float32; the top ``k`` of
``s + bias`` pick the experts (DeepSeek-V3's ``noaux_tc``: the bias moves
the choice and never the weights); the weights are the picked ``s``
divided by their sum (plus 1e-20, ``norm_topk_prob``) and multiplied by
``scale``.

``moe_forward``, all on the device with no read back to the host:

  1. dispatch: the (token, slot) pairs sorted by expert (a stable sort, so
     pairs of one expert keep the token order), each expert's end offset
     found by ``searchsorted`` on the sorted ids, the token rows gathered;
  2. experts: one grouped GEMM for gate and up together against
     ``gate_up`` (E, 2I, hidden), SiLU(gate) x up, one grouped GEMM against
     ``down`` (E, hidden, I) (``torch._grouped_mm``; an expert no pair
     chose is an empty group);
  3. combine: the outputs put back in (token, slot) order (each row written
     once, no atomics), weighted by the token's own weights and summed over
     its k slots in float32 by one reduction (no atomics: the same sum on
     every run).

A layer may hold a share of the experts, as each card of an expert-parallel
deployment does: ``first`` and ``count`` name the held range of the
router's experts, and ``gate_up`` / ``down`` stack those ``count``. The
router still scores and picks over all of its experts, and the weights
are normalised over all ``k`` picks; a pair whose expert lies outside the
range gets the id ``count``, past the held ones, before the sort, so the
stable sort puts it last and no grouped GEMM's group reaches it (the rows
past the last group are not computed); its output is replaced by zeros
before the combine (``torch.where``: those rows were never written). No
read goes back to the host. The result is the held experts' part of the
routed sum, which is what this card adds on the way to the next layer.
When the range covers every expert the path is the whole layer's, as
above, with no masking.

Spans (``utils/profiling.py``): ``moe.dispatch`` (router, sort, gather),
``moe.experts`` (the grouped GEMMs), ``moe.combine``. Counter:
``moe.routed_tokens``, the (token, slot) pairs of a call, from shapes.
Where ``hits`` (a one-element int64 tensor on the device) is given, the
number of (held) experts that at least one pair chose is added to it on
the device, and where ``pairs`` is given, the pairs computed here; the
caller reads them when it reads its own results.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from aladin_torch.utils import profiling


def route(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, top_k: int,
          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (T, k) float32, experts (T, k) int64) of rows ``h`` (T, hidden)."""
    scores = torch.sigmoid(F.linear(h.float(), weight.float()))  # float32 scores
    experts = torch.topk(scores + bias.float(), top_k, dim=-1, sorted=True).indices
    w = scores.gather(1, experts)
    return w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scale, experts


def grouped_swiglu(x: torch.Tensor, offsets: torch.Tensor, gate_up: torch.Tensor,
                   down: torch.Tensor) -> torch.Tensor:
    """Rows ``x`` (N, hidden) sorted by expert, ``offsets`` (E,) int32 each
    expert's end row: each row through its expert's SwiGLU."""
    width = down.shape[-1]
    gu = torch._grouped_mm(x, gate_up.transpose(1, 2), offs=offsets)
    a = F.silu(gu[:, :width]) * gu[:, width:]
    return torch._grouped_mm(a, down.transpose(1, 2), offs=offsets)


def moe_forward(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                gate_up: torch.Tensor, down: torch.Tensor, *, top_k: int, scale: float,
                hits: Optional[torch.Tensor] = None, first: int = 0,
                pairs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed sum of the held experts ``[first, first + count)``,
    ``count = gate_up.shape[0]``, for rows ``h`` (T, hidden), in h's dtype
    (module doc)."""
    t, n_exp = h.shape[0], gate_up.shape[0]
    share = n_exp != weight.shape[0]
    if not (h.is_cuda and torch.cuda.is_current_stream_capturing()):
        profiling.count("moe.routed_tokens", t * top_k)  # a CUDA graph's replays count their own
    with profiling.span("moe.dispatch"):
        w, experts = route(h, weight, bias, top_k, scale)
        flat = experts.reshape(-1)
        if share:
            flat = flat - first
            flat = torch.where((flat >= 0) & (flat < n_exp), flat, n_exp)
        order = torch.argsort(flat, stable=True)
        ends = torch.searchsorted(flat[order],
                                  torch.arange(n_exp, device=h.device, dtype=flat.dtype),
                                  right=True)
        x = h[order // top_k]
    if hits is not None:
        starts = torch.cat([ends.new_zeros(1), ends[:-1]])
        hits += (ends > starts).sum()
    if pairs is not None:
        pairs += ends[-1]
    with profiling.span("moe.experts"):
        y = grouped_swiglu(x, ends.to(torch.int32), gate_up, down)
    with profiling.span("moe.combine"):
        if share:
            y = torch.where((flat[order] < n_exp)[:, None], y, 0)
        slots = torch.empty_like(y)
        slots[order] = y
        out = (slots.view(t, top_k, -1) * w[..., None]).sum(dim=1)
    return out.to(h.dtype)
