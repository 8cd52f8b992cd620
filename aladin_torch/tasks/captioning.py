"""Image captioning: masked-LM training and static-shape decoding (mirrors
aladin_tpu/tasks/captioning.py).

Behavioral contract (ref:oscar/modeling/modeling_bert.py:604-911
BertForImageCaptioning, ref:oscar/run_captioning.py:195-325
CaptionTensorizer):

  * layout: [caption slots (max_seq_a), OD-label tokens (to max_seq), image
    regions (max_img_seq)]; 2-D attention mask - caption->caption lower
    triangle, caption->labels/regions full, labels/regions attend among
    themselves but NEVER to the caption (ref:run_captioning.py:297-317);
  * training: mask round(0.15 * len) of the caption tokens (<= 3), 80%
    [MASK] / 10% random / 10% keep; loss = label-smoothed KL over masked
    positions with optional drop-worst (ref:modeling_bert.py:575-601);
  * MLM head: transform (dense + the backbone's activation + LN) -> decoder
    tied to the word embeddings + bias (tie_weights,
    ref:modeling_bert.py:618-621), under pytorch_transformers' names
    (``cls.predictions.transform.dense``, ``cls.predictions.transform.
    LayerNorm``, ``cls.predictions.bias``); the tied matrix is the
    embedding table itself, passed in at each call;
  * decoding is masked-LM style: position t holds [MASK]; its logits emit
    token t.

Decoding: one loop a policy (greedy, sampling, fixed-width beam search),
each over a step source class that gives a step's logits. ``StepInputs``
recomputes the whole static forward every step, as aladin_tpu's
``lax.scan`` decoders do, in a plain Python loop over the same static
shapes: the caption buffer is pre-filled with [MASK], the causal triangle
makes the logits at position t depend only on tokens < t, and step t writes
position t. The MLM head runs only on position t's row (each row's numbers
are those of taking row t from every text position). The KV-cached source
is tasks/decode_cache.py's ``CachedSteps``; CBS runs its own
state-partitioned loop over ``StepInputs`` (tasks/cbs.py).

Ties: ``argmax`` takes the lower index, as ``jnp.argmax``, and every top-k
goes through ``ops/topk.py::top_k`` (the lower index first on equal
values, as ``lax.top_k``): beam scores start at ``[0, -1e9, ...]`` and
collide often.

Data parallelism (``mesh=`` of ``make_caption_train_step``): each rank holds
B / dp rows of the global batch and the loss is the global batch's. The
plain loss's denominator, the active-token count, is summed over the ranks
with the loss sums; drop-worst sorts the global batch's per-token losses
(gathered with a gradient), as aladin_tpu's jit sorts the global array.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from aladin_torch.models.bert_img import BertImgConfig, BertImgModel, ffn_act
from aladin_torch.ops.topk import top_k as stable_top_k
from aladin_torch.parallel.mesh import Mesh, all_gather_cat, all_reduce_sum_, gather_rows
from aladin_torch.train.schedule import AdamW
from aladin_torch.train.step import average_gradients, compute_autocast


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        return self.LayerNorm(ffn_act(self.dense(x), self.act))  # follows the backbone's act


class BertMLMHead(nn.Module):
    """(…, hidden) -> (…, vocab) f32 logits: transform, then the product
    with the tied (vocab, hidden) word embeddings plus ``bias``."""

    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.transform = BertPredictionHeadTransform(cfg)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, x: torch.Tensor, word_embeddings: torch.Tensor) -> torch.Tensor:
        return F.linear(self.transform(x), word_embeddings).float() + self.bias


class BertOnlyMLMHead(nn.Module):
    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.predictions = BertMLMHead(cfg)


Positions = Union[None, int, torch.Tensor]


class BertImageCaptioner(nn.Module):
    """Backbone + tied MLM head over the caption positions."""

    def __init__(self, cfg: BertImgConfig):
        super().__init__()
        self.bert = BertImgModel(cfg)
        self.cls = BertOnlyMLMHead(cfg)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The MLM head's f32 logits of hidden rows ``x``."""
        return self.cls.predictions(x, self.bert.embeddings.word_embeddings.weight)

    def forward(self, input_ids, attention_mask, token_type_ids, img_feats,
                positions: Positions = None) -> torch.Tensor:
        """f32 logits of the text positions: (B, L_text, vocab) for every
        one (``positions`` None), (B, vocab) of row ``positions`` (an int),
        or (B, M, vocab) of the rows a (B, M) index tensor names."""
        seq = self.bert(input_ids, attention_mask, token_type_ids, img_feats)[0]
        text = seq[:, :input_ids.shape[1]]
        if isinstance(positions, int):
            text = text[:, positions]
        elif positions is not None:
            text = torch.take_along_dim(text, positions.long()[..., None], dim=1)
        return self.head(text)


# ---------------------------------------------------------------------------
# Loss (ref:modeling_bert.py:575-601)
# ---------------------------------------------------------------------------


def caption_token_losses(logits: torch.Tensor, targets: torch.Tensor,
                         label_smoothing: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-token label-smoothed KL (N,), inf where inactive; active (N,)
    bool) of gathered masked-slot logits (N, vocab) and ids (N,), 0 =
    inactive slot. torch's kl_div adds q log q only where q > 0."""
    n_class = logits.shape[-1]
    eps = label_smoothing
    one_hot = F.one_hot(targets.long(), n_class).float()
    soft = one_hot * (1 - eps) + (1 - one_hot) * eps / (n_class - 1)
    logp = F.log_softmax(logits.float(), dim=-1)
    q_logq = torch.where(soft > 0, soft * torch.log(soft.clamp(min=1e-38)),
                         torch.zeros_like(soft))
    per_tok = torch.sum(q_logq - soft * logp, dim=-1)
    active = targets != 0  # padding masks removed (ref:modeling_bert.py:648)
    return torch.where(active, per_tok, torch.full_like(per_tok, float("inf"))), active


def _finite_sum(per_tok: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    ok = keep & torch.isfinite(per_tok)
    return torch.where(ok, per_tok, torch.zeros_like(per_tok)).sum()


def drop_worst_loss(per_tok: torch.Tensor, active: torch.Tensor,
                    drop_worst_ratio: float) -> torch.Tensor:
    """The mean of the ``max(floor(a (1 - ratio)), 1)`` smallest per-token
    losses, a the active count: the ascending sort puts the inactive ones
    (inf) last. The reference's k is int(active count * (1 - ratio))
    (ref:modeling_bert.py:595-597); the product is taken in f32, as
    aladin_tpu takes it."""
    sorted_loss = torch.sort(per_tok, stable=True).values
    a = active.sum().float()
    keep = torch.floor(a * (1.0 - drop_worst_ratio)).long().clamp(min=1)
    sel = torch.arange(per_tok.shape[0], device=per_tok.device) < keep
    return _finite_sum(sorted_loss, sel) / keep


def captioning_loss(logits: torch.Tensor, targets: torch.Tensor, label_smoothing: float = 0.1,
                    drop_worst_ratio: float = 0.0, drop_worst_active: bool = False
                    ) -> torch.Tensor:
    """The label-smoothed KL over the active masked slots: their mean, or
    with ``drop_worst_ratio`` > 0 and ``drop_worst_active`` the mean of the
    kept smallest (``drop_worst_loss``)."""
    per_tok, active = caption_token_losses(logits, targets, label_smoothing)
    if drop_worst_ratio > 0 and drop_worst_active:
        return drop_worst_loss(per_tok, active, drop_worst_ratio)
    return _finite_sum(per_tok, active) / active.sum().clamp(min=1)


def make_caption_train_step(model: BertImageCaptioner, optimizer: AdamW,
                            label_smoothing: float = 0.1, drop_worst_ratio: float = 0.0,
                            drop_worst_after: int = 0,
                            compute_dtype: Optional[torch.dtype] = None,
                            mesh: Optional[Mesh] = None):
    """step(ids, attn, seg, feats, masked_idx (B, M), masked_ids (B, M),
    epoch) -> {"loss"} (the global batch's with ``mesh``) after one AdamW
    update; drop-worst from ``epoch >= drop_worst_after`` on."""
    dp = mesh.size if mesh is not None else 1

    def step(ids, attn, seg, feats, midx, mids, epoch: int) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        with compute_autocast(ids.device, compute_dtype):
            logits = model(ids, attn, seg, feats, positions=midx)
        per_tok, active = caption_token_losses(logits.reshape(-1, logits.shape[-1]),
                                               mids.reshape(-1), label_smoothing)
        if drop_worst_ratio > 0 and epoch >= drop_worst_after:
            # the global batch's per-token losses, sorted together; every rank
            # reduces the same loss, and the gather's backward sums the ranks'
            # gradients: dp times this rank's share
            if mesh is not None:
                per_tok, active = gather_rows(mesh, per_tok), all_gather_cat(mesh, active)
            loss = drop_worst_loss(per_tok, active, drop_worst_ratio)
            loss.backward()
            loss = loss.detach()
        else:
            local = _finite_sum(per_tok, active)
            totals = torch.stack([local.detach(), active.sum().float()])
            if mesh is not None:
                totals = all_reduce_sum_(mesh, totals)
            denom = totals[1].clamp(min=1)
            # dp times this rank's share: the gradient average below divides by dp
            (dp * local / denom).backward()
            loss = totals[0] / denom
        if mesh is not None:
            average_gradients(mesh, [p.grad for p in optimizer.params if p.grad is not None])
        optimizer.step()
        return {"loss": loss}

    return step


# ---------------------------------------------------------------------------
# Tensorizer (ref:run_captioning.py:195-325)
# ---------------------------------------------------------------------------


class CaptionTensorizer:
    def __init__(self, tokenizer, max_img_seq_length=50, max_seq_length=70,
                 max_seq_a_length=40, mask_prob=0.15, max_masked_tokens=3,
                 img_feature_dim=2054, is_train=True, seed=0):
        self.tok = tokenizer
        self.max_img_seq_len = max_img_seq_length
        self.max_seq_len = max_seq_length
        self.max_seq_a_len = max_seq_a_length
        self.mask_prob = mask_prob
        self.max_masked = max_masked_tokens
        self.img_feature_dim = img_feature_dim
        self.is_train = is_train
        self.rng = np.random.RandomState(seed)
        ids = tokenizer.convert_tokens_to_ids(
            [tokenizer.pad_token, tokenizer.mask_token, tokenizer.cls_token,
             tokenizer.sep_token])
        self.pad_id, self.mask_id, self.cls_id, self.sep_id = ids

    def _encode_trunc(self, text: str, max_tokens: int):
        """tokenize -> truncate -> ids (data/tokenizer.py encode_trunc_any:
        C++ fast path or generic fallback)."""
        from aladin_torch.data.tokenizer import encode_trunc_any

        return encode_trunc_any(self.tok, text, max_tokens)

    def attention_mask(self, seq_a_len: int, seq_len: int, img_len: int) -> np.ndarray:
        """(L_total, L_total) 2-D mask, reference block layout."""
        la, lt, li = self.max_seq_a_len, self.max_seq_len, self.max_img_seq_len
        m = np.zeros((lt + li, lt + li), np.int32)
        tri = np.tril(np.ones((seq_a_len, seq_a_len), np.int32))
        m[:seq_a_len, :seq_a_len] = tri
        m[la:seq_len, la:seq_len] = 1  # L-L
        m[lt: lt + img_len, lt: lt + img_len] = 1  # R-R
        m[:seq_a_len, la:seq_len] = 1  # C->L
        m[:seq_a_len, lt: lt + img_len] = 1  # C->R
        m[la:seq_len, lt: lt + img_len] = 1  # L->R
        m[lt: lt + img_len, la:seq_len] = 1  # R->L
        return m

    def tensorize(self, caption: Optional[str], od_labels: Optional[str], feats: np.ndarray):
        if self.is_train:
            body_a = self._encode_trunc(caption, self.max_seq_a_len - 2)
        else:
            body_a = [self.mask_id] * (self.max_seq_a_len - 2)
        ids_list = [self.cls_id] + body_a + [self.sep_id]
        seg = [0] * len(ids_list)
        seq_a_len = len(ids_list)
        if od_labels:
            ids_list += [self.pad_id] * (self.max_seq_a_len - seq_a_len)
            seg += [0] * (self.max_seq_a_len - len(seg))
            room = self.max_seq_len - len(ids_list) - 1
            if room > 0:  # room<=0: even a bare [SEP] would overflow
                body_b = self._encode_trunc(od_labels, room)
                ids_list += body_b + [self.sep_id]
                seg += [1] * (len(body_b) + 1)
        seq_len = len(ids_list)

        masked_pos = np.zeros(self.max_seq_len, np.int32)
        masked_ids = np.zeros(self.max_masked, np.int64)
        if self.is_train:
            # id-level masking: vocab ids are line indices, so the
            # reference's random token draw (list(vocab)[randint]) is the
            # same distribution as a random id (ref:run_captioning.py:262-278)
            cand = list(range(1, seq_a_len))
            self.rng.shuffle(cand)
            num = int(min(max(round(self.mask_prob * seq_a_len), 1), self.max_masked))
            idx = sorted(cand[:num])
            originals = [ids_list[i] for i in idx]
            for pos in idx:
                r = self.rng.rand()
                if r <= 0.8:
                    ids_list[pos] = self.mask_id
                elif self.rng.rand() <= 0.5:
                    ids_list[pos] = int(self.rng.randint(len(self.tok.vocab)))
            masked_pos[idx] = 1
            masked_ids[: len(originals)] = originals
        else:
            masked_pos[:] = 1

        ids_list += [self.pad_id] * (self.max_seq_len - seq_len)
        seg += [0] * (self.max_seq_len - len(seg))
        input_ids = np.asarray(ids_list, np.int32)

        img_len = min(feats.shape[0], self.max_img_seq_len)
        out_feats = np.zeros((self.max_img_seq_len, self.img_feature_dim), np.float32)
        out_feats[:img_len] = feats[:img_len, : self.img_feature_dim]
        attn = self.attention_mask(seq_a_len, seq_len, img_len)
        return input_ids, attn, np.asarray(seg, np.int32), out_feats, masked_pos, masked_ids


# ---------------------------------------------------------------------------
# Decoding (static shapes; see the module docstring)
# ---------------------------------------------------------------------------


def _decode_attention_mask(max_seq_a, max_seq, max_img, od_len, img_len, dtype=np.int32):
    """Static decode mask: full triangle over caption slots."""
    m = np.zeros((max_seq + max_img, max_seq + max_img), dtype)
    m[:max_seq_a, :max_seq_a] = np.tril(np.ones((max_seq_a, max_seq_a), dtype))
    l0, l1 = max_seq_a, max_seq_a + od_len
    r0, r1 = max_seq, max_seq + img_len
    m[l0:l1, l0:l1] = 1
    m[r0:r1, r0:r1] = 1
    m[:max_seq_a, l0:l1] = 1
    m[:max_seq_a, r0:r1] = 1
    m[l0:l1, r0:r1] = 1
    m[r0:r1, l0:l1] = 1
    return m


def initial_caption(b: int, max_seq_a: int, cls_id: int, mask_id: int, device) -> torch.Tensor:
    """(B, max_seq_a) int64: [CLS] then [MASK] in every slot."""
    cap = torch.full((b, max_seq_a), mask_id, dtype=torch.long, device=device)
    cap[:, 0] = cls_id
    return cap


def finished_pad_row(v: int, pad_id: int, device) -> torch.Tensor:
    """(V,) f32 log-probs of a finished beam: 0 for [PAD], -1e9 elsewhere."""
    row = torch.full((v,), -1e9, device=device)
    row[pad_id] = 0.0
    return row


class StepInputs:
    """The full-recompute step source: the constant parts of the decode
    forward (the token types of [caption | OD labels] and the OD-label ids,
    beside the mask and features), each tiled ``beams`` times (the beams of
    an example are consecutive rows). Puts the model in eval mode.

    A step source gives the (rows, V) f32 logits at caption position ``t``
    (``logits(cap, t, prev)``, ``prev`` the token at t - 1) and follows a
    beam expansion (``reorder(rows)``); ``span()`` is the context a whole
    decode over it runs in. The full step reads the whole (reordered)
    ``cap``, and its inputs are beam-invariant within an example, so its
    reorder does nothing and ``prev`` is not read. ``mask_id`` is the
    cached source's (the [MASK] probes are already in ``cap`` here)."""

    span = contextlib.nullcontext  # a full-recompute decode is no span of its own

    def __init__(self, model: BertImageCaptioner, od_ids, od_seg, img_feats, attn_mask,
                 max_seq_a: int, *, mask_id: Optional[int] = None, beams: int = 1):
        if beams > 1:
            od_ids, od_seg, img_feats, attn_mask = (
                x.repeat_interleave(beams, dim=0) for x in (od_ids, od_seg, img_feats, attn_mask))
        b = od_ids.shape[0]
        self.model = model.eval()
        self.od_ids = od_ids.long()
        self.seg = torch.cat([torch.zeros(b, max_seq_a, dtype=torch.long, device=od_ids.device),
                              od_seg.long()], dim=1)
        self.feats, self.mask = img_feats, attn_mask

    def logits(self, cap: torch.Tensor, t: int, prev: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """(rows, V) f32 logits at caption position ``t`` of ``cap``."""
        ids = torch.cat([cap, self.od_ids], dim=1)
        return self.model(ids, self.mask, self.seg, self.feats, positions=t)

    def reorder(self, rows: torch.Tensor) -> None:
        pass


@torch.no_grad()
def greedy_decode(steps, model: BertImageCaptioner, od_ids, od_seg, img_feats, attn_mask, *,
                  max_steps: int, cls_id: int, sep_id: int, mask_id: int, pad_id: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy masked-LM decode over the step source class ``steps``
    (``StepInputs``, or ``tasks/decode_cache.py::CachedSteps``) in eval mode
    (the model is left in it). Returns (tokens (B, max_steps + 1), summed
    log-probs (B,))."""
    b, s = img_feats.shape[0], max_steps + 1
    with steps.span():
        src = steps(model, od_ids, od_seg, img_feats, attn_mask, s, mask_id=mask_id)
        cap = initial_caption(b, s, cls_id, mask_id, img_feats.device)
        finished = torch.zeros(b, dtype=torch.bool, device=cap.device)
        logprob = torch.zeros(b, device=cap.device)
        prev = cap[:, 0].clone()
        for t in range(1, s):
            logp = F.log_softmax(src.logits(cap, t, prev), dim=-1)
            tok = logp.argmax(dim=-1)
            tok_lp = logp.gather(1, tok[:, None])[:, 0]
            tok = torch.where(finished, pad_id, tok)
            logprob += torch.where(finished, 0.0, tok_lp)
            cap[:, t] = tok  # PAD for finished rows
            finished |= tok == sep_id
            prev = tok
        return cap, logprob


def beam_step(scores: torch.Tensor, step_logp: torch.Tensor, finished: torch.Tensor,
              b: int, k: int, pad_id: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One beam expansion: (top scores (B, K), source rows (B*K,), tokens
    (B*K,)) of the candidates ``scores + step_logp`` (finished beams extend
    only with [PAD], at no cost)."""
    v = step_logp.shape[-1]
    step_logp = torch.where(finished[:, None], finished_pad_row(v, pad_id, scores.device),
                            step_logp)
    cand = (scores[:, None] + step_logp).reshape(b, k * v)
    top_scores, top_idx = stable_top_k(cand, k)
    rows = (top_idx // v + torch.arange(b, device=cand.device)[:, None] * k).reshape(-1)
    return top_scores, rows, (top_idx % v).reshape(-1)


def initial_beam_scores(b: int, k: int, device) -> torch.Tensor:
    """(B*K,): beam 0 alive, the others at -1e9, so the first expansion
    seeds distinct tokens."""
    return torch.tensor([0.0] + [-1e9] * (k - 1), device=device).repeat(b)


def best_beam(cap, scores, lengths, b: int, k: int, length_penalty: float):
    """(tokens (B, L), normalized score (B,)) of each example's best beam."""
    norm = (scores / lengths.float() ** length_penalty).reshape(b, k)
    best = norm.argmax(dim=1)
    rows = torch.arange(b, device=cap.device)
    return cap.reshape(b, k, -1)[rows, best], norm[rows, best]


@torch.no_grad()
def beam_search_decode(steps, model: BertImageCaptioner, od_ids, od_seg, img_feats, attn_mask,
                       *, max_steps: int, num_beams: int = 5, cls_id: int, sep_id: int,
                       mask_id: int, pad_id: int, length_penalty: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-width beam search (beams folded into the batch) over the step
    source class ``steps`` in eval mode; the source follows each expansion's
    source rows. Returns the best (tokens (B, max_steps + 1),
    length-normalized score) per example - the capability of the
    reference's _generate_beam_search (ref:oscar/modeling/modeling_utils.py)
    with static shapes."""
    b, k, s = img_feats.shape[0], num_beams, max_steps + 1
    with steps.span():
        src = steps(model, od_ids, od_seg, img_feats, attn_mask, s, mask_id=mask_id, beams=k)
        cap = initial_caption(b * k, s, cls_id, mask_id, img_feats.device)
        scores = initial_beam_scores(b, k, cap.device)
        finished = torch.zeros(b * k, dtype=torch.bool, device=cap.device)
        lengths = torch.ones(b * k, dtype=torch.long, device=cap.device)
        prev = cap[:, 0].clone()
        for t in range(1, s):
            logp = F.log_softmax(src.logits(cap, t, prev), dim=-1)
            top_scores, rows, tok = beam_step(scores, logp, finished, b, k, pad_id)
            cap, finished, lengths = cap[rows], finished[rows], lengths[rows]
            src.reorder(rows)
            prev = torch.where(finished, pad_id, tok)
            cap[:, t] = prev
            lengths = torch.where(finished, lengths, lengths + 1)
            finished = finished | (tok == sep_id)
            scores = top_scores.reshape(-1)
        return best_beam(cap, scores, lengths, b, k, length_penalty)


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw a row from softmax(logits) by the Gumbel-max trick, as
    ``jax.random.categorical`` draws (uniforms from ``generator``, which
    must live on the logits' device)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp(min=torch.finfo(u.dtype).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


@torch.no_grad()
def sample_decode(steps, model: BertImageCaptioner, od_ids, od_seg, img_feats, attn_mask,
                  generator: torch.Generator, *, max_steps: int, cls_id: int, sep_id: int,
                  mask_id: int, pad_id: int, top_k: int = 0, top_p: float = 1.0,
                  temperature: float = 1.0) -> torch.Tensor:
    """Stochastic masked-LM decode over the step source class ``steps`` in
    eval mode (the SCST sampling pass, ref:oscar/run_captioning.py:522-580
    capability): like greedy_decode but each step draws from the (top-k /
    top-p filtered) softmax, one uniform row a step from ``generator``, so
    the same generator state and the same logits give the same caption
    whatever the source. Returns token rows (B, max_steps + 1); the policy
    gradient's log-probs come from token_logprobs."""
    b, s = img_feats.shape[0], max_steps + 1
    with steps.span():
        src = steps(model, od_ids, od_seg, img_feats, attn_mask, s, mask_id=mask_id)
        cap = initial_caption(b, s, cls_id, mask_id, img_feats.device)
        finished = torch.zeros(b, dtype=torch.bool, device=cap.device)
        prev = cap[:, 0].clone()
        for t in range(1, s):
            logits = top_k_top_p_filtering(src.logits(cap, t, prev) / temperature, top_k, top_p)
            tok = torch.where(finished, pad_id, categorical(logits, generator))
            cap[:, t] = tok
            finished |= tok == sep_id
            prev = tok
        return cap


def token_logprobs(model: BertImageCaptioner, tokens: torch.Tensor, od_ids, od_seg, img_feats,
                   attn_mask, *, mask_id: int, pad_id: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable per-token log-probs of decoded captions under the
    conditioning the decoder used: the log-prob at position t is evaluated
    with positions >= t re-masked (prefix teacher forcing), one checkpointed
    forward a step, in eval mode (the model is left in it, so the backward's
    recompute runs without dropout too). Returns (logprobs (B, T), mask
    (B, T)) over positions 1..max_seq_a-1; padding tokens are masked out.
    This is the gradient path of SCST: loss = -advantage * sum(logprobs *
    mask)."""
    tokens = tokens.long()
    s = tokens.shape[1]
    inp = StepInputs(model, od_ids, od_seg, img_feats, attn_mask, s)
    pos = torch.arange(s, device=tokens.device)[None, :]

    def logp_at(t: int) -> torch.Tensor:
        cap = torch.where(pos < t, tokens, mask_id)
        step_logp = F.log_softmax(inp.logits(cap, t), dim=-1)
        return step_logp.gather(1, tokens[:, t:t + 1])[:, 0]

    lps = torch.stack([checkpoint(logp_at, t, use_reentrant=False) for t in range(1, s)], dim=1)
    return lps, (tokens[:, 1:] != pad_id).to(lps.dtype)


def top_k_top_p_filtering(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0,
                          filter_value: float = -1e9) -> torch.Tensor:
    """Sampling filter (ref:oscar/modeling/modeling_utils.py:600-633
    capability), static-shape version: entries below the k-th largest, and
    below the nucleus's cutoff, become ``filter_value``."""
    if top_k > 0:
        kth = stable_top_k(logits, top_k)[0][..., -1:]
        logits = torch.where(logits < kth, filter_value, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True, stable=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, filter_value, logits)
    return logits
