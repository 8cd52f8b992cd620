"""Constrained Beam Search (CBS) for captioning (mirrors
aladin_tpu/tasks/cbs.py).

Equivalent capability to ref:oscar/utils/cbs.py (ConstrainedBeamSearch,
ConstraintFilter, FiniteStateMachineBuilder, select_best_beam_with_constraints):
decoding is conditioned on a finite state machine whose states encode which
detection-derived constraints the caption has satisfied; the search keeps
``beam_size`` beams PER FSM STATE and, at the end, returns the best finished
beam among states satisfying at least ``min_constraints_to_satisfy``.

Representation: the reference builds a dense (S, S, V) adjacency
(ref:cbs.py:649-655); its FSMs are deterministic, so the compact (S, V)
next-state table is stored (a converter from the adjacency form is
provided). Main states are the first 2^C states - bit i of the state index
means constraint i is satisfied (ref:cbs.py:700-747); multi-token
constraints pass through chain substates appended after the main block.

The host parts (the FSM builder, the constraint filter, the final
selection) are copies of aladin_tpu's numpy code. The search runs on the
device over static (B, S, K) beam tensors, a Python loop over the steps of
the full-recompute masked-LM step of tasks/captioning.py; the per-step
transition is one gather and a top-k a target state, through
``ops/topk.py::top_k`` (the lower index first on ties, as ``lax.top_k``).
The masked candidates are -inf before the top-k and non-finite scores are
clamped to -1e9 after it.

Host-side constraint selection (ConstraintFilter, ref:cbs.py:526-645):
class-hierarchy blacklist removal, NMS suppression of generic classes, top-k
by detector confidence.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aladin_torch.ops.topk import top_k as stable_top_k
from aladin_torch.tasks.captioning import (BertImageCaptioner, StepInputs, finished_pad_row,
                                           initial_caption)


# ---------------------------------------------------------------------------
# FSM construction (host side)
# ---------------------------------------------------------------------------

class FiniteStateMachineBuilder:
    """Build a deterministic (S, V) next-state table from constraint word
    forms. Constraint i is a list of alternative token-id sequences
    (word forms); completing any form flips bit i of the main state."""

    def __init__(self, vocab_size: int, max_constraints: int = 3):
        self.vocab_size = vocab_size
        self.max_constraints = max_constraints

    def build(self, constraint_forms: Sequence[List[List[int]]]) -> Tuple[np.ndarray, int]:
        """constraint_forms[i] = list of token-id sequences for constraint i.
        Returns (next_state (S, V) int32, num_states).

        Overlap semantics (the "completing any form flips bit i" contract):
        a token that is itself a single-token form still earns its bit when
        consumed as the FIRST or LAST token of another constraint's chain —
        e.g. with 'snow' and ['snow','##board'], the caption 'snow hill'
        earns bit(snow) (the substate's fallback rows carry it), and with
        'truck' and ['fire','truck'], 'fire truck' earns BOTH bits. A
        substate falls back to the full transition row of the main state
        holding its earned bits, so chain re-entry and single-token
        completions keep working mid-chain. Known limitation (as in the
        dense reference table, ref:cbs.py:649-747): two multi-token chains
        from the same state sharing a first token clobber each other (last
        one wins)."""
        c = len(constraint_forms)
        assert c <= self.max_constraints
        n_main = 1 << c

        def tok_bits(state: int, tok: int) -> int:
            """Bits of single-token constraints that consuming `tok` from
            main state `state` completes."""
            bits = 0
            for i, forms in enumerate(constraint_forms):
                if not (state >> i) & 1 and any(
                    len(f) == 1 and f[0] == tok for f in forms
                ):
                    bits |= 1 << i
            return bits

        # collect chain substates for multi-token forms
        chains = []  # (main_from, bit, form tokens)
        for i, forms in enumerate(constraint_forms):
            for form in forms:
                assert len(form) >= 1
                if len(form) > 1:
                    for m in range(n_main):
                        if not (m >> i) & 1:
                            chains.append((m, i, form))
        n_sub = sum(len(f) - 1 for _, _, f in chains)
        s_total = n_main + n_sub
        nxt = np.tile(np.arange(s_total, dtype=np.int32)[:, None], (1, self.vocab_size))

        # pass 1: single-token transitions (bits for ALL constraints the
        # token completes, not one overwriting another)
        toks = {f[0] for forms in constraint_forms for f in forms if len(f) == 1}
        for m in range(n_main):
            for tok in toks:
                bits = tok_bits(m, tok)
                if bits:
                    nxt[m, tok] = m | bits

        # pass 2a: assign substate ids + install chain entry transitions
        # into the main states (before substate rows are copied, so chains
        # can re-enter each other from a substate fallback)
        sub = n_main
        chain_subs = []  # (sub ids per chain)
        for m, i, form in chains:
            ids = list(range(sub, sub + len(form) - 1))
            sub += len(form) - 1
            chain_subs.append(ids)
            nxt[m, form[0]] = ids[0]

        # pass 2b: fill substate rows. After consuming t0..tk the earned
        # single-token bits are accumulated in `acc`; the substate behaves
        # like main state `acc` for every non-advancing token.
        for (m, i, form), ids in zip(chains, chain_subs):
            acc = m | tok_bits(m, form[0])
            for step in range(1, len(form)):
                s_id = ids[step - 1]
                nxt[s_id, :] = nxt[acc, :]
                tok = form[step]
                if step == len(form) - 1:
                    nxt[s_id, tok] = acc | tok_bits(acc, tok) | (1 << i)
                else:
                    acc = acc | tok_bits(acc, tok)
                    nxt[s_id, tok] = ids[step]
        return nxt, s_total


def adjacency_to_next_state(fsm: np.ndarray) -> np.ndarray:
    """(S, S, V) boolean adjacency (the reference layout) -> (S, V) table.
    A (state, token) column with no outgoing edge self-loops (argmax over
    all-False would otherwise silently teleport to state 0, clearing every
    satisfied-constraint bit)."""
    nxt = np.argmax(fsm, axis=1).astype(np.int32)
    has_edge = fsm.any(axis=1)
    self_loop = np.arange(fsm.shape[0], dtype=np.int32)[:, None]
    return np.where(has_edge, nxt, self_loop)


def num_constraints_satisfied(states: np.ndarray, num_constraints: int) -> np.ndarray:
    """popcount of the main-state bits. Chain substates (index >= 2^C) carry
    in-progress bits not recoverable from the index alone, so they count as
    0 — conservative, and moot for selection: finished captions are judged
    by select_best_beam_with_constraints over main states only."""
    s = np.atleast_1d(states)
    n_main = 1 << num_constraints
    return np.asarray([bin(int(x)).count("1") if x < n_main else 0 for x in s])


class ConstraintFilter:
    """Detection -> constraint candidates (ref:cbs.py:526-645): drop
    blacklisted classes, NMS-suppress generics, keep top-k by score."""

    BLACKLIST = {"background", "self", "other", "thing", "stuff"}

    def __init__(self, hierarchy: Optional[Dict[str, str]] = None,
                 nms_threshold: float = 0.85, max_given_constraints: int = 3):
        self.hierarchy = hierarchy or {}  # child class -> parent class
        self.nms_threshold = nms_threshold
        self.max_given = max_given_constraints

    @staticmethod
    def _iou(a, b):
        x1, y1 = max(a[0], b[0]), max(a[1], b[1])
        x2, y2 = min(a[2], b[2]), min(a[3], b[3])
        inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
        area = lambda r: max(0.0, r[2] - r[0]) * max(0.0, r[3] - r[1])  # noqa: E731
        union = area(a) + area(b) - inter
        return inter / union if union > 0 else 0.0

    def __call__(self, boxes: np.ndarray, class_names: List[str], scores: np.ndarray) -> List[str]:
        order = np.argsort(-np.asarray(scores))
        kept: List[int] = []
        for idx in order:
            name = class_names[idx].lower()
            if name in self.BLACKLIST:
                continue
            suppressed = False
            for j in kept:
                if self._iou(boxes[idx], boxes[j]) > self.nms_threshold:
                    # the more specific class (a hierarchy descendant) wins
                    if self.hierarchy.get(class_names[j].lower()) == name:
                        continue  # kept one is more specific; drop this
                    suppressed = True
                    break
            if not suppressed:
                kept.append(int(idx))
            if len(kept) >= self.max_given:
                break
        # dedup by name, preserve score order
        seen, out = set(), []
        for j in kept:
            n = class_names[j].lower()
            if n not in seen:
                seen.add(n)
                out.append(n)
        return out[: self.max_given]


# ---------------------------------------------------------------------------
# The search (device side)
# ---------------------------------------------------------------------------


@torch.no_grad()
def cbs_decode(model: BertImageCaptioner, od_ids, od_seg, img_feats, attn_mask,
               next_state: torch.Tensor, *, max_steps: int, num_beams: int, num_states: int,
               cls_id: int, sep_id: int, mask_id: int, pad_id: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """State-partitioned beam search in eval mode over per-example FSM tables
    ``next_state`` (B, S, V). Returns (tokens (B, S, K, L), scores (B, S, K),
    finished (B, S, K)); callers pick the best beam among sufficiently
    constrained states with select_best_beam_with_constraints."""
    b = img_feats.shape[0]
    s, k = num_states, num_beams
    g, length = b * s * k, max_steps + 1
    inp = StepInputs(model, od_ids, od_seg, img_feats, attn_mask, length, beams=s * k)
    dev = img_feats.device
    cap = initial_caption(g, length, cls_id, mask_id, dev).reshape(b, s, k, length)
    scores = torch.full((b, s, k), -1e9, device=dev)
    scores[:, 0, 0] = 0.0  # only (state 0, beam 0) starts alive
    finished = torch.zeros((b, s, k), dtype=torch.bool, device=dev)
    next_state = next_state.to(dev).long()
    own_state = torch.arange(s, device=dev)[None, :, None, None]
    bidx = torch.arange(b, device=dev)[:, None, None]
    for t in range(1, length):
        logp = F.log_softmax(inp.logits(cap.reshape(g, length), t), dim=-1)
        v = logp.shape[-1]
        logp = logp.reshape(b, s, k, v)
        logp = torch.where(finished[..., None], finished_pad_row(v, pad_id, dev), logp)
        cand = scores[..., None] + logp  # (B, S, K, V)
        # the target state of each (source state, token); finished beams stay put
        tgt = torch.where(finished[..., None], own_state, next_state[:, :, None, :])
        outs = []
        for sp in range(s):
            masked = torch.where(tgt == sp, cand, float("-inf")).reshape(b, s * k * v)
            outs.append(stable_top_k(masked, k))  # (B, K) each
        new_scores = torch.stack([o[0] for o in outs], dim=1)  # (B, S, K)
        top_ix = torch.stack([o[1] for o in outs], dim=1)
        src_state, src_beam = top_ix // (k * v), (top_ix % (k * v)) // v
        tok = top_ix % v
        cap = cap[bidx, src_state, src_beam]  # (B, S, K, L)
        fin_new = finished[bidx, src_state, src_beam]
        cap[..., t] = torch.where(fin_new, pad_id, tok)
        finished = fin_new | (tok == sep_id)
        scores = torch.where(torch.isfinite(new_scores), new_scores, -1e9)
    return cap, scores, finished


def select_best_beam_with_constraints(
    tokens: np.ndarray,  # (B, S, K, L)
    scores: np.ndarray,  # (B, S, K)
    num_constraints: np.ndarray,  # (B,) constraints given per example
    min_constraints_to_satisfy: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pick, per example, the best beam among main states satisfying
    >= min(num_constraints, min_required) constraints
    (ref:cbs.py:366-433 semantics)."""
    b, s, k, l = tokens.shape
    best_tokens = np.zeros((b, l), tokens.dtype)
    best_scores = np.full((b,), -np.inf, np.float32)
    for i in range(b):
        need = min(int(num_constraints[i]), min_constraints_to_satisfy)
        for state in range(s):
            sat = bin(state & ((1 << int(num_constraints[i])) - 1)).count("1")
            if state < (1 << int(num_constraints[i])) and sat >= need:
                j = int(np.argmax(scores[i, state]))
                if scores[i, state, j] > best_scores[i]:
                    best_scores[i] = scores[i, state, j]
                    best_tokens[i] = tokens[i, state, j]
    return best_tokens, best_scores
