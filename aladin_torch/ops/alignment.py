"""Fine-grained region-word alignment scoring (mirrors aladin_tpu/ops/alignment.py).

Contract: l2-normalise the token sets (eps 1e-12), strip the special tokens
(images drop token 0, captions drop token 0 and the last two slots; lengths
shrink by 1 and 3), form alignments[b, c, r, w] = <im[b, r], s[c, w]>,
zero every entry past a length, and aggregate to a (B_i, B_c) matrix.

The zero fill is load-bearing: for the max-type aggregations the padded
zeros floor a row of all-negative real values at 0. Shapes are static as in
aladin_tpu: R and W are the buffer widths, so every sample shorter than its
buffer has the floor and the 'mean' denominator is the static area.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from aladin_torch.ops.masking import valid_mask
from aladin_torch.ops.similarity import l2norm

AGGREGATIONS = ("sum", "mean", "MrSw", "MrAVGw", "symm", "MwSr", "scan-sentences")


def strip_special_tokens(im_set, s_seq, im_len, s_len):
    """Drop CLS/first-region (images) and CLS + last two slots (captions)."""
    return im_set[:, 1:, :], s_seq[:, 1:-2, :], im_len - 1, s_len - 3


def alignment_scores(im_set: torch.Tensor, s_seq: torch.Tensor, im_len: torch.Tensor,
                     s_len: torch.Tensor, aggregation: str = "MrSw", *,
                     normalized: bool = False) -> torch.Tensor:
    """Dense (B_i, B_c) alignment score matrix from UN-stripped token sets
    (B_i, S_im, D) / (B_c, S_s, D) and lengths that include special tokens."""
    if aggregation not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {aggregation!r}")
    if not normalized:
        im_set = l2norm(im_set, eps=1e-12)
        s_seq = l2norm(s_seq, eps=1e-12)
    im_set, s_seq, im_len, s_len = strip_special_tokens(im_set, s_seq, im_len, s_len)
    im_valid = valid_mask(im_len, im_set.shape[1])
    s_valid = valid_mask(s_len, s_seq.shape[1])

    align = torch.einsum("brd,cwd->bcrw", im_set.float(), s_seq.float())
    pair_valid = im_valid[:, None, :, None] & s_valid[None, :, None, :]
    align = torch.where(pair_valid, align, torch.zeros((), dtype=align.dtype, device=align.device))

    if aggregation == "sum":
        return align.sum(dim=(2, 3))
    if aggregation == "mean":
        return align.mean(dim=(2, 3))
    if aggregation == "MrSw":
        return align.amax(dim=2).sum(dim=2)
    if aggregation == "MrAVGw":
        per_word = align.amax(dim=2).sum(dim=2)
        return per_word / s_len.to(per_word.dtype)[None, :]
    if aggregation == "symm":
        return align.amax(dim=2).sum(dim=2) + align.amax(dim=3).sum(dim=2)
    if aggregation == "MwSr":
        return align.amax(dim=3).sum(dim=2)
    return _scan_sentences(im_set.float(), s_seq.float(), im_valid, pair_valid, align)


def _scan_sentences(im_set, s_seq, im_valid, pair_valid, align):
    """SCAN-style attention aggregation: relu -> l2-normalise over regions ->
    softmax over words (masked, guarded so fully padded rows give 0, not NaN)
    -> attention-weighted caption vector per region -> cosine with the
    region -> zero padded regions -> sum over regions."""
    w = torch.relu(align)
    w = w / torch.clamp(torch.sqrt(torch.sum(torch.square(w), dim=2, keepdim=True)), min=1e-12)
    w = torch.where(pair_valid, w, torch.full((), float("-inf"), dtype=w.dtype, device=w.device))
    w_max = torch.amax(w, dim=3, keepdim=True)
    finite = torch.isfinite(w)
    shift = torch.where(torch.isfinite(w_max), w_max, torch.zeros_like(w_max))
    e = torch.where(finite, torch.exp(w - shift), torch.zeros_like(w))
    denom = torch.sum(e, dim=3, keepdim=True)
    attn = torch.where(denom > 0, e / torch.clamp(denom, min=1e-30), torch.zeros_like(e))
    att_vec = torch.einsum("bcrw,cwd->bcrd", attn, s_seq)
    im = im_set[:, None, :, :]
    num = torch.sum(im * att_vec, dim=3)
    # torch cosine_similarity clamps the denominator at 1e-8
    den = torch.clamp(torch.linalg.norm(im, dim=3) * torch.linalg.norm(att_vec, dim=3), min=1e-8)
    cos = torch.where(im_valid[:, None, :], num / den, torch.zeros_like(num))
    return cos.sum(dim=2)


def alignment_scores_chunked(im_set: torch.Tensor, s_seq: torch.Tensor, im_len: torch.Tensor,
                             s_len: torch.Tensor, aggregation: str = "MrSw", chunk: int = 64, *,
                             normalized: bool = False) -> torch.Tensor:
    """``alignment_scores`` with bounded memory, differentiable: the caption
    axis goes in ``chunk``-sized blocks and each block is recomputed in the
    backward pass (``torch.utils.checkpoint``, JAX's remat), so the
    (B_i, B_c, R, W) tensor never exists whole in either direction. The last
    block may be short: no padding captions are needed."""
    if not normalized:
        im_set = l2norm(im_set, eps=1e-12)
        s_seq = l2norm(s_seq, eps=1e-12)

    def block(ims, seq, il, sl):
        return alignment_scores(ims, seq, il, sl, aggregation, normalized=True)

    return torch.cat([
        checkpoint(block, im_set, s_seq[s:s + chunk], im_len, s_len[s:s + chunk],
                   use_reentrant=False)
        for s in range(0, s_seq.shape[0], chunk)
    ], dim=1)


@torch.no_grad()
def score_all_pairs(im_set: torch.Tensor, s_seq: torch.Tensor, im_len: torch.Tensor,
                    s_len: torch.Tensor, aggregation: str = "MrSw", block_caps: int = 256,
                    normalized: bool = False) -> torch.Tensor:
    """(N_im, N_cap) alignment scores, one block of captions at a time, so
    the (N_im, block, R, W) intermediate stays bounded. The last block may be
    short: no padding captions are needed."""
    if not normalized:
        im_set = l2norm(im_set.float(), eps=1e-12)
        s_seq = l2norm(s_seq.float(), eps=1e-12)
    blocks = [
        alignment_scores(im_set, s_seq[s:s + block_caps], im_len, s_len[s:s + block_caps],
                         aggregation, normalized=True)
        for s in range(0, s_seq.shape[0], block_caps)
    ]
    return torch.cat(blocks, dim=1)
