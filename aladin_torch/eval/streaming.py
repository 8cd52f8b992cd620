"""Streaming recall: exact ranks without the dense score matrix (mirrors
aladin_tpu/eval/streaming.py on one device).

Every recall metric derives from ranks, and a rank is a count:

    rank(q) = #{j != gt(q) : S[q, j] > S[q, gt(q)]}

so recall needs (1) the ground-truth pair scores, one per caption, and (2) a
sweep over caption blocks in which each (N_im, block) score tile updates
per-image greater-than counters (i2t, one per ground-truth slot) and gives
the ranks of its own columns (t2i), after which the tile is dropped. The
device holds the image buffers, one caption block and int32 counters;
captions may be host numpy arrays (beyond device memory: blocks go to the
device one at a time) or a tensor.

Exactness: a tile entry is compared with a ground-truth score, so both must
carry the same rounding. The ground truth is harvested as the diagonal of
gathered paired blocks run through the same tile scorer. On the card that
holds for the MrSw kernel (K1) because its score does not depend on the
corpus shape, bit for bit; for the matching head's f32 product the cuBLAS
product must round an element the same whatever the matrix shape, which
``chip_smoke.py`` checks for every pair. The ground truth's own column (i2t)
and row (t2i) are excluded by index, not by the strict inequality: the
count over a tile is taken whole and the own entry's hit subtracted, which
is the reference's count without its (N_im, block) index mask. The streamed
ranks then equal ``ranks_from_score_matrix`` of the matrix the same scorer
would give.

int8 scoring (``compute_dtype=torch.int8``) quantizes with per-call scales,
so a ground-truth block and a sweep tile quantize differently and int8
streaming is not exact, as in aladin_tpu.

Multi-device sweeps (``mesh=``) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aladin_torch.eval.recall import recall_metrics
from aladin_torch.ops.alignment import score_all_pairs
from aladin_torch.ops.kernels.alignment_kernel import mrsw_scores
from aladin_torch.ops.similarity import l2norm
from aladin_torch.ops.topk import top_k

_MESH_ERROR = ("multi-device streaming (mesh=) is not ported yet "
               "(ROADMAP.md, queue 1, item 7: multi-GPU)")


def _dev(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as f32 on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _host_ints(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _take(x, idx: np.ndarray):
    """Rows ``idx`` of a numpy array or a tensor (on its own device)."""
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(idx, device=x.device)]
    return x[idx]


# ---------------------------------------------------------------------------
# the tile counting rule (shared by matching and alignment)
# ---------------------------------------------------------------------------


def _tile_counts(S: torch.Tensor, lo: int, n_valid: int, gt_flat: torch.Tensor, cpi: int,
                 topk: int = 0):
    """Counter updates from one (N_im, B) score tile whose columns are the
    captions ``lo .. lo + n_valid`` followed by padding at -inf.

    Returns (d_i2t (N_im, cpi) int32 count partials, t2i ranks (B,) int32
    complete for these columns, the tile's top-k (scores, caption ids) or
    None). Padding columns carry id 0, as in aladin_tpu.
    """
    n, b = S.shape
    device = S.device
    gt_i2t = gt_flat.view(n, cpi)
    parts = []
    for g in range(cpi):
        d = (S > gt_i2t[:, g:g + 1]).sum(dim=1, dtype=torch.int32)
        # the rows whose own column r * cpi + g lies in this tile
        r_lo = max(0, -(-(lo - g) // cpi))
        r_hi = min(n, -(-(lo + n_valid - g) // cpi))
        if r_hi > r_lo:
            rows = torch.arange(r_lo, r_hi, device=device)
            own = S[rows, rows * cpi + g - lo] > gt_i2t[r_lo:r_hi, g]
            d[r_lo:r_hi] -= own.to(torch.int32)
        parts.append(d)
    d_i2t = torch.stack(parts, dim=1)

    gt_t2i = F.pad(gt_flat[lo:lo + n_valid], (0, b - n_valid))
    t2i = (S > gt_t2i[None, :]).sum(dim=0, dtype=torch.int32)
    cols = torch.arange(n_valid, device=device)
    own = S[(cols + lo) // cpi, cols] > gt_t2i[:n_valid]
    t2i[:n_valid] -= own.to(torch.int32)

    tk = None
    if topk:
        v, i = top_k(S, min(topk, b))
        ids = torch.arange(lo, lo + b, device=device)
        ids[n_valid:] = 0
        tk = (v, ids[i])
    return d_i2t, t2i, tk


def _merge_topk(carry, tile, topk: int):
    """Running top-k merge: the carry followed by the tile's top-k, re-top-k."""
    if carry is None:
        v, c = tile
        pad = topk - v.shape[1]
        if pad > 0:
            v = F.pad(v, (0, pad), value=float("-inf"))
            c = F.pad(c, (0, pad), value=-1)
        return v, c
    v = torch.cat([carry[0], tile[0]], dim=1)
    c = torch.cat([carry[1], tile[1]], dim=1)
    vv, ii = top_k(v, topk)
    return vv, torch.gather(c, 1, ii)


# ---------------------------------------------------------------------------
# tile scorers
# ---------------------------------------------------------------------------


def _matching_tile(ims: torch.Tensor, caps_blk: torch.Tensor) -> torch.Tensor:
    """(N_im, B) f32 product; the port never enables TF32."""
    return torch.matmul(ims, caps_blk.T)


def _alignment_tile(ims, il, caps_blk, cl_blk, aggregation: str, use_kernel: bool,
                    compute_dtype) -> torch.Tensor:
    if aggregation == "MrSw" and use_kernel:
        return mrsw_scores(ims, caps_blk, il, cl_blk, compute_dtype=compute_dtype)
    block = min(256, caps_blk.shape[0])
    return score_all_pairs(ims, caps_blk, il, cl_blk, aggregation, block, normalized=True)


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------


def _sweep(tile_fn, n_cap: int, cap_block: int, n_im: int, cpi: int, block_inputs,
           device: torch.device, topk: int = 0):
    """Block sweep over the captions. ``tile_fn(inputs, lo, n_valid)`` maps
    one block's device inputs to counter updates; ``block_inputs(lo, hi)``
    returns those inputs. Results stay on the device until the end."""
    counts = torch.zeros((n_im, cpi), dtype=torch.int32, device=device)
    t2i_parts = []
    tk = None
    for lo in range(0, n_cap, cap_block):
        hi = min(lo + cap_block, n_cap)
        d_i2t, t2i, tile_tk = tile_fn(block_inputs(lo, hi), lo, hi - lo)
        counts += d_i2t
        t2i_parts.append(t2i[:hi - lo])
        if topk:
            tk = _merge_topk(tk, tile_tk, topk)
    i2t_ranks = counts.min(dim=1).values.cpu().numpy()
    t2i_ranks = torch.cat(t2i_parts).cpu().numpy()
    if topk:
        return i2t_ranks, t2i_ranks, (tk[0].cpu().numpy(), tk[1].cpu().numpy())
    return i2t_ranks, t2i_ranks, None


def _masked(S: torch.Tensor, n_valid: int) -> torch.Tensor:
    if n_valid < S.shape[1]:
        S[:, n_valid:] = float("-inf")
    return S


def matching_ground_truth(ims: torch.Tensor, cap_glob, cpi: int, gt_block: int) -> torch.Tensor:
    """gt[j] = <ims[j // cpi], cap[j]> as the diagonal of (gt_block x
    gt_block) products through the sweep's tile scorer; the tail block is
    padded with zero rows so every product has one shape."""
    n_cap = cap_glob.shape[0]
    device = ims.device
    gt = torch.empty((n_cap,), dtype=torch.float32, device=device)
    for lo in range(0, n_cap, gt_block):
        hi = min(lo + gt_block, n_cap)
        blk = _dev(cap_glob[lo:hi], device)
        rows = ims[torch.arange(lo, hi, device=device) // cpi]
        if hi - lo < gt_block:
            blk = F.pad(blk, (0, 0, 0, gt_block - (hi - lo)))
            rows = F.pad(rows, (0, 0, 0, gt_block - (hi - lo)))
        gt[lo:hi] = torch.diagonal(_matching_tile(rows, blk))[:hi - lo]
    return gt


@torch.no_grad()
def streaming_matching_ranks(img_glob, cap_glob, captions_per_image: int = 5,
                             cap_block: int = 32768, topk: int = 0, mesh=None,
                             device="cuda"):
    """(i2t_ranks (N,), t2i_ranks (M,)[, topk (scores, ids)]) as numpy over
    global embeddings, never materializing the (N, M) matrix.

    img_glob: (N, D) unique image embeddings (callers with the 5-per-image
    row layout pass img_embs[::cpi]); cap_glob: (M, D) caption embeddings,
    a host array (blocks go to ``device`` one at a time) or a tensor.
    """
    if mesh is not None:
        raise NotImplementedError(_MESH_ERROR)
    device = torch.device(device)
    cpi = captions_per_image
    ims = _dev(img_glob, device)
    n_im, n_cap = ims.shape[0], cap_glob.shape[0]
    assert n_cap == n_im * cpi, (n_cap, n_im, cpi)
    gt = matching_ground_truth(ims, cap_glob, cpi, min(4096, cap_block))

    def block_inputs(lo, hi):
        blk = _dev(cap_glob[lo:hi], device)
        if hi - lo < cap_block:  # tail: padded so every tile has one shape
            blk = F.pad(blk, (0, 0, 0, cap_block - (hi - lo)))
        return blk

    def tile_fn(blk, lo, n_valid):
        S = _masked(_matching_tile(ims, blk), n_valid)
        return _tile_counts(S, lo, n_valid, gt, cpi, topk)

    i2t, t2i, tk = _sweep(tile_fn, n_cap, cap_block, n_im, cpi, block_inputs, device, topk)
    return (i2t, t2i, tk) if topk else (i2t, t2i)


@torch.no_grad()
def streaming_alignment_ranks(img_sets, cap_seqs, img_lens, cap_lens, aggregation: str = "MrSw",
                              captions_per_image: int = 5, cap_block: int = 2048,
                              use_kernel: Optional[bool] = None, compute_dtype=None, mesh=None,
                              device="cuda"):
    """(i2t_ranks (N,), t2i_ranks (M,)) as numpy for the alignment head, streamed.

    img_sets: (M, S, D) encode buffers with images repeated per caption
    (deduplicated here, as evaluate_alignment_head does); cap_seqs: (M, S,
    D), a host array or a tensor. ``use_kernel`` (default: ``device`` is
    CUDA) scores MrSw tiles with ``mrsw_scores`` (K1 on the card, its plain
    version on the CPU) in ``compute_dtype`` (bf16 by default); otherwise
    ``score_all_pairs`` scores in f32.
    """
    if mesh is not None:
        raise NotImplementedError(_MESH_ERROR)
    device = torch.device(device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    if compute_dtype is None:
        compute_dtype = torch.bfloat16
    cpi = captions_per_image
    ims = l2norm(_dev(img_sets[::cpi], device), eps=1e-12)
    il = torch.as_tensor(_host_ints(img_lens)[::cpi], device=device)
    n_im, n_cap = ims.shape[0], cap_seqs.shape[0]
    assert n_cap == n_im * cpi, (n_cap, n_im, cpi)
    cl = torch.as_tensor(_host_ints(cap_lens), device=device)

    def tile(rows, il_rows, blk, cl_blk):
        return _alignment_tile(rows, il_rows, blk, cl_blk, aggregation, use_kernel,
                               compute_dtype)

    # ground truth: caption j against image j // cpi, the diagonal of paired
    # blocks through the same tile scorer; the tail repeats its last pair
    gt_block = min(512, cap_block)
    gt = torch.empty((n_cap,), dtype=torch.float32, device=device)
    for lo in range(0, n_cap, gt_block):
        hi = min(lo + gt_block, n_cap)
        idx = np.minimum(np.arange(lo, lo + gt_block), hi - 1)
        img_idx = torch.as_tensor(idx // cpi, device=device)
        blk = l2norm(_dev(_take(cap_seqs, idx), device), eps=1e-12)
        S = tile(ims[img_idx], il[img_idx], blk, cl[torch.as_tensor(idx, device=device)])
        gt[lo:hi] = torch.diagonal(S)[:hi - lo]

    def block_inputs(lo, hi):
        blk = torch.zeros((cap_block,) + tuple(cap_seqs.shape[1:]), dtype=torch.float32,
                          device=device)
        blk[:hi - lo] = _dev(cap_seqs[lo:hi], device)
        cl_blk = torch.full((cap_block,), 4, dtype=cl.dtype, device=device)
        cl_blk[:hi - lo] = cl[lo:hi]
        return l2norm(blk, eps=1e-12), cl_blk

    def tile_fn(inputs, lo, n_valid):
        S = _masked(tile(ims, il, *inputs), n_valid)
        return _tile_counts(S, lo, n_valid, gt, cpi)

    i2t, t2i, _ = _sweep(tile_fn, n_cap, cap_block, n_im, cpi, block_inputs, device)
    return i2t, t2i


# ---------------------------------------------------------------------------
# metric front-ends
# ---------------------------------------------------------------------------


def _metrics(i2t_ranks, t2i_ranks) -> Tuple[Dict[str, float], Dict[str, float]]:
    return recall_metrics(i2t_ranks), recall_metrics(t2i_ranks)


def streaming_matching_recall(img_glob, cap_glob, captions_per_image: int = 5,
                              cap_block: int = 32768, mesh=None,
                              device="cuda") -> Dict[str, float]:
    """compute_recall's dict (i2t_* / t2i_* / rsum), streamed."""
    i2t, t2i = streaming_matching_ranks(img_glob, cap_glob, captions_per_image, cap_block,
                                        mesh=mesh, device=device)
    m_i2t, m_t2i = _metrics(i2t, t2i)
    out = {f"i2t_{k}": v for k, v in m_i2t.items()}
    out.update({f"t2i_{k}": v for k, v in m_t2i.items()})
    out["rsum"] = sum(out[k] for k in ("i2t_r1", "i2t_r5", "i2t_r10", "t2i_r1", "t2i_r5",
                                       "t2i_r10"))
    return out


def streaming_alignment_recall(img_sets, cap_seqs, img_lens, cap_lens, aggregation: str = "MrSw",
                               captions_per_image: int = 5, cap_block: int = 2048,
                               **kw) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(i2t, t2i) metric dicts as evaluate_alignment_head's, streamed (no
    NDCG: it needs each query's full ordering)."""
    i2t, t2i = streaming_alignment_ranks(img_sets, cap_seqs, img_lens, cap_lens, aggregation,
                                         captions_per_image, cap_block, **kw)
    return _metrics(i2t, t2i)
