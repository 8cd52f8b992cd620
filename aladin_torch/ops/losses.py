"""All training losses as functions over score matrices and embeddings
(mirrors aladin_tpu/ops/losses.py).

Hinge triplet with hardest-negative mining, the alignment contrastive loss,
four score-distillation modes, attention distillation, the uniformity
(entropy) regulariser, the hidden-state L1 term, CLIP-style InfoNCE, the
semantic contrastive loss, the permutation-invariant matching loss, and
``combine_losses``. Score matrices are (B_i, B_c) with row = image,
column = caption, diagonal = matched pairs; results are f32 scalars.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from aladin_torch.ops.alignment import alignment_scores, alignment_scores_chunked
from aladin_torch.ops.masking import valid_mask
from aladin_torch.ops.similarity import get_similarity


def _off_diagonal(n: int, device) -> torch.Tensor:
    return ~torch.eye(n, dtype=torch.bool, device=device)


def contrastive_hinge(scores: torch.Tensor, margin: float, max_violation: bool) -> torch.Tensor:
    """Bidirectional hinge triplet over a square in-batch score matrix:
    cost_s[i, j] = max(0, margin + S[i, j] - S[i, i]), cost_im[i, j] =
    max(0, margin + S[i, j] - S[j, j]), diagonals cleared; with
    ``max_violation`` only the hardest negative per row / column counts."""
    diag = torch.diagonal(scores)
    off = _off_diagonal(scores.shape[0], scores.device)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    cost_s = torch.where(off, torch.clamp(margin + scores - diag[:, None], min=0.0), zero)
    cost_im = torch.where(off, torch.clamp(margin + scores - diag[None, :], min=0.0), zero)
    if max_violation:
        cost_s = cost_s.amax(dim=1)
        cost_im = cost_im.amax(dim=0)
    return cost_s.sum() + cost_im.sum()


def matching_loss(im: torch.Tensor, s: torch.Tensor, margin: float = 0.2, measure: str = "dot",
                  max_violation: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global-embedding triplet loss: (loss, B x B score matrix)."""
    scores = get_similarity(measure)(im, s)
    return contrastive_hinge(scores, margin, max_violation), scores


def alignment_contrastive_loss(im_set, s_seq, im_len, s_len, margin: float = 0.2,
                               max_violation: bool = True, aggregation: str = "MrSw",
                               normalized: bool = False,
                               chunk: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine-grained alignment triplet loss: (loss, score matrix). ``chunk``
    > 0 bounds memory through the checkpointed chunked scorer."""
    if chunk > 0:
        scores = alignment_scores_chunked(im_set, s_seq, im_len, s_len, aggregation, chunk,
                                          normalized=normalized)
    else:
        scores = alignment_scores(im_set, s_seq, im_len, s_len, aggregation,
                                  normalized=normalized)
    return contrastive_hinge(scores, margin, max_violation), scores


# ---------------------------------------------------------------------------
# Score distillation
# ---------------------------------------------------------------------------

def distillation_mse(teacher: torch.Tensor, student: torch.Tensor,
                     wb: torch.Tensor) -> torch.Tensor:
    """MSE with a learned affine [scale, shift] on the student (init
    [0.5, 0.5])."""
    student = student * wb[0] + wb[1]
    return torch.mean(torch.square(student - teacher.detach()))


def _safe_mean(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Mean over the kept elements; 0 if none."""
    cnt = keep.sum()
    total = torch.where(keep, x, torch.zeros_like(x)).sum()
    return torch.where(cnt > 0, total / torch.clamp(cnt, min=1), torch.zeros_like(total))


def distillation_ordinal(teacher: torch.Tensor, student: torch.Tensor, margin: float = 0.2,
                         threshold: float = 0.1, stride: int = 3) -> torch.Tensor:
    """Rank-order hinge: the student reproduces the teacher's per-row and
    per-column orderings."""
    teacher = teacher.detach()

    def one_direction(t, s):
        order = torch.argsort(t, dim=1, stable=True)  # ascending
        t_sorted = torch.gather(t, 1, order)
        s_sorted = torch.gather(s, 1, order)
        diffs = s_sorted[:, :-stride] - s_sorted[:, stride:]
        keep = t_sorted[:, stride:] >= threshold
        return _safe_mean(torch.relu(margin + diffs), keep)

    return one_direction(teacher, student) + one_direction(teacher.T, student.T)


def distillation_contrastive(teacher: torch.Tensor, student: torch.Tensor,
                             margin: float = 0.2) -> torch.Tensor:
    """Hinge whose hardest negative the TEACHER chooses, summed as the
    reference's index_select does: cost_s[i, neg_s[j]] over all (i, j)."""
    teacher = teacher.detach()
    off = _off_diagonal(teacher.shape[0], teacher.device)
    t_nodiag = torch.where(off, teacher, torch.zeros_like(teacher))
    diag = torch.diagonal(student)
    cost_s = torch.clamp(margin + student - diag[:, None], min=0.0)
    cost_im = torch.clamp(margin + student - diag[None, :], min=0.0)
    neg_s = torch.argmax(t_nodiag, dim=1)
    neg_im = torch.argmax(t_nodiag, dim=0)
    return cost_s[:, neg_s].sum() + cost_im[neg_im, :].sum()


def distillation_listnet(teacher: torch.Tensor, student: torch.Tensor, temperature: float = 6.0,
                         eps: float = 1e-10) -> torch.Tensor:
    """ListNet: cross-entropy between the row / column softmaxes of the
    teacher and of the temperature-sharpened student (the shipped default)."""
    teacher = teacher.detach()

    def one_axis(dim):
        p = torch.softmax(student * temperature, dim=dim) + eps
        q = torch.softmax(teacher, dim=dim)
        return torch.mean(-torch.sum(q * torch.log(p), dim=dim))

    return one_axis(1) + one_axis(0)


def distillation_loss(teacher: torch.Tensor, student: torch.Tensor, mode: str = "listnet", *,
                      wb: Optional[torch.Tensor] = None, margin: float = 0.2,
                      threshold: float = 0.1, stride: int = 3) -> torch.Tensor:
    """Dispatch over the four modes."""
    if mode == "mse":
        if wb is None:
            raise ValueError("mse distillation needs the learnable (2,) wb")
        return distillation_mse(teacher, student, wb)
    if mode == "ordinal":
        return distillation_ordinal(teacher, student, margin, threshold, stride)
    if mode == "contrastive":
        return distillation_contrastive(teacher, student, margin)
    if mode == "listnet":
        return distillation_listnet(teacher, student)
    raise ValueError(f"unknown distillation mode {mode!r}")


# ---------------------------------------------------------------------------
# Attention distillation
# ---------------------------------------------------------------------------

def attention_distillation_loss(im_set, s_seq, im_len, s_len,
                                teacher_attentions: torch.Tensor) -> torch.Tensor:
    """KL(teacher word->region attention || student alignment softmax).
    Strips token 0 on both sides, scales by 1/sqrt(d), softmaxes the
    alignments over valid regions per word, l1-normalises the teacher rows
    and takes the batchmean KL over real words; contributions outside each
    sample's valid regions are zero. teacher_attentions: (B_i, B_c, W_t, R_t)
    with W_t >= W, R_t >= R."""
    im_set, s_seq = im_set[:, 1:, :].float(), s_seq[:, 1:, :].float()
    im_len, s_len = im_len - 1, s_len - 1
    d = im_set.shape[2]
    r_len, w_len = im_set.shape[1], s_seq.shape[1]
    align = torch.einsum("brd,cwd->bcrw", im_set, s_seq) / torch.sqrt(
        torch.tensor(float(d), device=im_set.device))
    align = align.permute(0, 1, 3, 2)  # (B_i, B_c, W, R)
    im_valid = valid_mask(im_len, r_len)
    s_valid = valid_mask(s_len, w_len)
    region_mask = im_valid[:, None, None, :]
    logp = torch.log_softmax(
        torch.where(region_mask, align, torch.full((), float("-inf"), device=align.device)), dim=-1)
    teacher = teacher_attentions[:, :, :w_len, :r_len].float()
    teacher = teacher / torch.clamp(teacher.abs().sum(dim=3, keepdim=True), min=1e-30)
    keep = (teacher > 0) & region_mask
    zero = torch.zeros((), device=align.device)
    safe_logq = torch.where(keep, torch.log(torch.clamp(teacher, min=1e-38)), zero)
    kl = torch.where(keep, teacher * (safe_logq - torch.where(keep, logp, zero)), zero)
    kl = torch.where(s_valid[None, :, :, None], kl, zero)
    n_rows = torch.clamp(s_valid.sum() * im_set.shape[0], min=1)
    return kl.sum() / n_rows


# ---------------------------------------------------------------------------
# Auxiliary losses
# ---------------------------------------------------------------------------

def entropy_uniformity_loss(img_emb: torch.Tensor, cap_emb: torch.Tensor) -> torch.Tensor:
    """Uniformity regulariser: -log(n * distance to the nearest neighbour),
    averaged over the pooled embedding set."""
    x = torch.cat([img_emb, cap_emb], dim=0).float()
    n = x.shape[0]
    dots = torch.matmul(x, x.T)
    dots = torch.where(torch.eye(n, dtype=torch.bool, device=x.device),
                       torch.full((), -1.0, device=x.device), dots)
    nn_idx = torch.argmax(dots, dim=1)
    dist = torch.linalg.norm(x - x[nn_idx], dim=1)
    return -torch.mean(torch.log(n * dist))


def l1_hidden_regularization(hidden_img: torch.Tensor, hidden_txt: torch.Tensor,
                             coef: float = 0.001) -> torch.Tensor:
    """Mean l1 norm of the stacked hidden states, times ``coef``."""
    l1_img = torch.mean(torch.sum(hidden_img.abs(), dim=-1))
    l1_txt = torch.mean(torch.sum(hidden_txt.abs(), dim=-1))
    return coef * (l1_img + l1_txt) / 2.0


def info_nce_loss(im: torch.Tensor, s: torch.Tensor,
                  log_temperature: torch.Tensor) -> torch.Tensor:
    """CLIP-style symmetric cross-entropy with a learned temperature."""
    logits = torch.matmul(im.float(), s.float().T) * torch.exp(log_temperature)
    labels = torch.arange(im.shape[0], device=im.device)
    return (F.cross_entropy(logits.T, labels) + F.cross_entropy(logits, labels)) / 2.0


def semantic_contrastive_loss(im: torch.Tensor, s: torch.Tensor, relevances: torch.Tensor,
                              generator: Optional[torch.Generator] = None, margin: float = 0.2,
                              threshold: float = 0.4, measure: str = "dot",
                              max_violation: bool = True) -> torch.Tensor:
    """Relevance-thresholded positives: per row and per column a random
    above-threshold entry (the diagonal always qualifies) plays the
    anchor-positive role, picked by Gumbel-max with noise from
    ``generator``."""
    scores = get_similarity(measure)(im, s)
    n = scores.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=scores.device)
    matching = (relevances > threshold) | eye

    def pick(mask_rows):
        u = torch.rand(mask_rows.shape, generator=generator, device=mask_rows.device)
        g = -torch.log(-torch.log(u.clamp(min=1e-20)))
        return torch.argmax(torch.where(mask_rows, g, torch.full_like(g, float("-inf"))), dim=1)

    rows = torch.arange(n, device=scores.device)
    d1 = scores[rows, pick(matching)][:, None]
    d2 = scores.T[rows, pick(matching.T)][None, :]
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    cost_s = torch.where(~eye, torch.clamp(margin + scores - d1, min=0.0), zero)
    cost_im = torch.where(~eye, torch.clamp(margin + scores - d2, min=0.0), zero)
    if max_violation:
        cost_s = cost_s.amax(dim=1)
        cost_im = cost_im.amax(dim=0)
    return cost_s.sum() + cost_im.sum()


def perm_inv_matching_loss(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Permutation-invariant set matching via softmin over pairwise l2
    distances. im: (B, R, D), s: (B, W, D)."""
    im, s = im.float(), s.float()
    d2 = ((im * im).sum(dim=-1)[:, :, None] - 2.0 * torch.einsum("brd,bwd->brw", im, s)
          + (s * s).sum(dim=-1)[:, None, :])
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    row_sum = torch.softmax(-dist, dim=2).amax(dim=2).sum(dim=1)
    col_sum = torch.softmax(-dist, dim=1).amax(dim=1).sum(dim=1)
    return torch.mean(dist.shape[1] * 2.0 - row_sum - col_sum)


# ---------------------------------------------------------------------------
# Loss combination
# ---------------------------------------------------------------------------

def combine_losses(loss_dict: Dict[str, torch.Tensor], weights: Dict[str, float],
                   auto_weights: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Fixed-weight sum, or uncertainty weighting 0.5 * sum(L e^{-s} + s)
    with learnable s (the reference's never reach its optimizer)."""
    if auto_weights is not None:
        total = sum(v * torch.exp(-auto_weights[k]) + auto_weights[k]
                    for k, v in loss_dict.items())
        return 0.5 * total.squeeze()
    return sum(v * weights[k] for k, v in loss_dict.items())
