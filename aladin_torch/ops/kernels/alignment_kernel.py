"""Fused MrSw all-pairs scoring: the CUDA kernel, its plain version, and the
caption-length rule of bucketed scoring (mirrors
aladin_tpu/ops/pallas/alignment_kernel.py).

``mrsw_scores`` has the contract of ``aladin_tpu``'s ``mrsw_scores_pallas``:
UN-stripped token sets with lengths that include the special tokens, and a
(N_im, N_cap) f32 result ``score[i, c] = sum_w max_r <im[i, r], cap[c, w]>``.
In torch it l2-normalises the images (eps 1e-12), strips them and zeroes
their padded regions. The captions are planned on the host from one read of
their lengths (``_plan``): sorted by valid word count (a stable sort), their
valid words packed back to back, and cut into 256-column tiles that each
hold whole captions. Only those words are gathered and l2-normalised. Both
operands are cast to the operand type; int8 builds per-tensor scales
``127 / max(max|x|, 1e-6)``, rounds and clips to +-127, and multiplies the
integer scores by ``1 / (s_im * s_cap)``. Then the same plan is walked:

  * a CUDA tensor launches ``csrc/mrsw_kernel.cu`` (bf16 or int8 operands;
    f32 raises, since the kernel has no f32 path); a failed build or launch
    raises;
  * a CPU tensor walks the plan in plain PyTorch (``_walk_plain``): the
    same tiles multiplied in f32, each caption's word maxima summed.

``mrsw_scores_plain`` is the reference: the whole (N_cap, W) caption
buffer prepared and multiplied in f32 (``_plain_core``). int8 dot products
are exact integers in f32 (768 * 127^2 < 2^24) and both int8 word sums are
taken in f64, so they equal the kernel's int32 sums.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aladin_torch.ops.kernels import build
from aladin_torch.ops.masking import valid_mask
from aladin_torch.ops.similarity import l2norm
from aladin_torch.utils import profiling

_KERNEL_SOURCE = "mrsw_kernel.cu"
_DTYPE_CODE = {torch.bfloat16: 0, torch.int8: 1}
_MAX_ROWS = 128  # the kernel's limit: at most 128 region rows / words a caption
_IMAGE_GROUP = 8  # images interleaved in one group of the kernel's image operand
_SLAB_SLOTS = 8  # region slots of an image in one of the kernel's 64-row slabs
_TAIL_SLOTS = 2  # region slots of an image in the kernel's 16-row tail pass
_TILE_COLS = 256  # word columns of one caption tile (the kernel's wgmma N)
_ROW_BYTES = 128  # bytes of D the kernel loads per row and stage
_PLAIN_BLOCK_ELEMS = 64 << 20  # f32 alignment elements per plain-version block


def _normalised_images(im_set, im_len):
    """l2-normalised (eps 1e-12), stripped f32 images, zero past each length."""
    im = l2norm(im_set.float(), eps=1e-12)[:, 1:]
    zero = torch.zeros((), dtype=im.dtype, device=im.device)
    return torch.where(valid_mask(im_len - 1, im.shape[1])[:, :, None], im, zero)


def _int8_scale(peak):
    return 127.0 / torch.clamp(peak, min=1e-6)


def _quantise(x, scale):
    return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)


def _prepare(im_set, s_seq, im_len, s_len, compute_dtype):
    """Normalise, strip, zero the padding and cast the whole buffers: (im,
    cap, descale), the reference's operands."""
    _check_dtype(compute_dtype)
    im = _normalised_images(im_set, im_len)
    cap = l2norm(s_seq.float(), eps=1e-12)[:, 1:-2]  # CLS and the last two slots stripped
    zero = torch.zeros((), dtype=cap.dtype, device=cap.device)
    cap = torch.where(valid_mask(s_len - 3, cap.shape[1])[:, :, None], cap, zero)
    if compute_dtype == torch.int8:
        s_im = _int8_scale(im.abs().amax())
        s_cap = _int8_scale(cap.abs().amax())
        return _quantise(im, s_im), _quantise(cap, s_cap), 1.0 / (s_im * s_cap)
    return im.to(compute_dtype), cap.to(compute_dtype), None


def _check_dtype(compute_dtype):
    if compute_dtype not in (torch.bfloat16, torch.int8, torch.float32):
        raise ValueError(f"compute_dtype must be bfloat16, int8 or float32, got {compute_dtype}")


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    lib = build.load_library(_KERNEL_SOURCE)
    lib.mrsw_scores_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mrsw_scores_launch.restype = ctypes.c_int
    lib.mrsw_error_string.argtypes = [ctypes.c_int]
    lib.mrsw_error_string.restype = ctypes.c_char_p
    return lib


class _Plan(NamedTuple):
    """Where each caption's words go: ``caps`` (N_cap, 4) int32 in packed
    order (by word count, stably), each row the caption's first column in
    its tile, its word count, its output column and its first word row of
    the packed operand; ``tiles`` (T, 4) int32, each row the tile's first
    word row, first packed caption and caption count (and a zero); ``cols``
    the tile width; ``n_words`` the packed rows."""
    caps: np.ndarray
    tiles: np.ndarray
    cols: int
    n_words: int


def _plan(counts: np.ndarray) -> _Plan:
    """Pack whole captions of ``counts`` valid words into tiles of 256
    columns (wider only for a caption longer than that, which the kernel
    refuses), greedily in length order: a tile closes when the next
    caption's words, or a 257th caption, would not fit. For any lengths
    this needs no more tiles than floor(256 / W16) whole captions a tile,
    W16 the longest rounded up to 16: each full tile holds at least that
    many."""
    counts = np.asarray(counts, dtype=np.int64).reshape(-1)
    n = counts.size
    cols = max(_TILE_COLS, int(counts.max()) if n else 0)
    key = counts.astype(np.int16) if cols < 2 ** 15 else counts  # int16 sorts by radix
    order = np.argsort(key, kind="stable")
    sorted_counts = counts[order]
    first = np.zeros(n + 1, np.int64)
    np.cumsum(sorted_counts, out=first[1:])
    # the tile that starts at caption i ends before caption nxt[i]
    at = np.arange(n)
    nxt = np.searchsorted(first, first[:-1] + cols, side="right") - 1
    nxt = np.maximum(np.minimum(nxt, at + _TILE_COLS), at + 1)
    starts, i = [], 0
    while i < n:
        starts.append(i)
        i = nxt[i]
    starts = np.asarray(starts, np.int64)
    per_tile = np.diff(np.append(starts, n))
    tiles = np.zeros((starts.size, 4), np.int32)
    tiles[:, 0], tiles[:, 1], tiles[:, 2] = first[starts], starts, per_tile
    caps = np.empty((n, 4), np.int32)
    caps[:, 0] = first[:-1] - np.repeat(first[starts], per_tile)
    caps[:, 1], caps[:, 2], caps[:, 3] = sorted_counts, order, first[:-1]
    return _Plan(caps, tiles, cols, int(first[-1]))


def _table(plan: _Plan, groups: Optional[np.ndarray], device) -> torch.Tensor:
    """The plan as one int32 buffer on ``device``, one upload: the tiles,
    the captions and, for per-group int8 scales, each packed caption's
    group."""
    parts = [plan.tiles.reshape(-1), plan.caps.reshape(-1)]
    if groups is not None:
        parts.append(np.asarray(groups, np.int32)[plan.caps[:, 2]])
    return torch.from_numpy(np.concatenate(parts)).to(device)


def _packed_operands(im_set, s_seq, im_len, plan: _Plan, table: torch.Tensor, compute_dtype,
                     groups: Optional[np.ndarray]):
    """(im, words, descale): the images as ``_prepare`` makes them, and the
    valid caption words in packed order, gathered from the UN-stripped
    buffer (word j of a caption is slot j + 1) and l2-normalised. int8
    scales the captions per tensor, or per group of ``groups`` (a group id
    a caption), and then ``descale`` is a column vector."""
    im = _normalised_images(im_set, im_len)
    caps = table[plan.tiles.size:plan.tiles.size + plan.caps.size].view(-1, 4).long()
    counts = caps[:, 1]
    n_words, n_groups = plan.n_words, 0 if groups is None else int(np.max(groups, initial=0)) + 1

    def spread(x):  # a value a packed caption -> a value a packed word
        return torch.repeat_interleave(x, counts, output_size=n_words)

    pos = torch.arange(n_words, device=im.device) - spread(caps[:, 3]) + 1
    words = l2norm(s_seq[spread(caps[:, 2]), pos].float(), eps=1e-12)
    if compute_dtype != torch.int8:
        return im.to(compute_dtype), words.to(compute_dtype), None
    s_im = _int8_scale(im.abs().amax())
    if groups is None:
        peak = words.abs().amax() if n_words else words.new_zeros(())
        s_cap = _int8_scale(peak)
        return _quantise(im, s_im), _quantise(words, s_cap), 1.0 / (s_im * s_cap)
    group = table[plan.tiles.size + plan.caps.size:].long()
    word_group = spread(group)
    peak = words.new_zeros(n_groups).scatter_reduce_(0, word_group, words.abs().amax(dim=-1),
                                                     "amax")
    s_cap = _int8_scale(peak)
    descale = torch.empty(len(plan.caps), dtype=torch.float32, device=im.device)
    descale[caps[:, 2]] = (1.0 / (s_im * s_cap))[group]
    return _quantise(im, s_im), _quantise(words, s_cap[word_group][:, None]), descale


def _plain_walk(im: torch.Tensor, words: torch.Tensor, plan: _Plan,
                table: torch.Tensor) -> torch.Tensor:
    """The kernel's walk of ``plan`` in plain PyTorch: each tile's ``cols``
    word rows from its first (rows past the operand read as zeros), the max
    over region slots, then each caption's word maxima summed (int8 in
    f64, exact; else f32)."""
    n_im, r, d = im.shape
    cols, n_tiles = plan.cols, len(plan.tiles)
    out = torch.zeros(n_im, len(plan.caps), dtype=torch.float32, device=im.device)
    if n_im == 0 or plan.n_words == 0:
        return out
    acc = torch.float64 if im.dtype == torch.int8 else torch.float32
    flat = im.float().reshape(n_im * r, d)
    rows_op = torch.cat([words.float(), words.new_zeros(cols, d, dtype=torch.float32)])
    longest = int(plan.caps[:, 1].max())
    block = max(1, _PLAIN_BLOCK_ELEMS // (n_im * cols * max(r, longest)))
    tile_first = torch.as_tensor(plan.tiles[:, 0].astype(np.int64), device=im.device)
    lane = torch.arange(cols, device=im.device)
    for t0 in range(0, n_tiles, block):
        t1 = min(t0 + block, n_tiles)
        rows = (tile_first[t0:t1, None] + lane).reshape(-1)
        colmax = (flat @ rows_op[rows].T).view(n_im, r, -1).amax(dim=1)
        c0, c1 = int(plan.tiles[t0, 1]), int(plan.tiles[t1 - 1, 1] + plan.tiles[t1 - 1, 2])
        tile = np.repeat(np.arange(t1 - t0), plan.tiles[t0:t1, 2])  # a caption's, in the block
        sel = plan.caps[c0:c1]
        keep = sel[:, 1] > 0
        sel, tile = sel[keep], tile[keep]
        if not len(sel):
            continue
        base = torch.as_tensor(tile * cols + sel[:, 0], device=im.device)
        count = torch.as_tensor(sel[:, 1], device=im.device)
        j = torch.arange(longest, device=im.device)
        got = colmax[:, (base[:, None] + j).clamp(max=colmax.shape[1] - 1)]
        got = torch.where(j < count[:, None], got, torch.zeros((), device=im.device))
        out[:, torch.as_tensor(sel[:, 2].astype(np.int64), device=im.device)] = (
            got.to(acc).sum(dim=-1).float())
    return out


def _plain_core(im: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """sum_w max_r <im[i, r], cap[c, w]> over prepared operands, in f32."""
    n_im, r, d = im.shape
    n_cap, w, _ = cap.shape
    flat = im.float().reshape(n_im * r, d)
    out = torch.empty(n_im, n_cap, dtype=torch.float32, device=im.device)
    block = max(1, _PLAIN_BLOCK_ELEMS // max(1, n_im * r * w))
    for s in range(0, n_cap, block):
        blk = cap[s:s + block].float()
        align = (flat @ blk.reshape(-1, d).T).reshape(n_im, r, blk.shape[0], w)
        word_max = align.amax(dim=1)
        if im.dtype == torch.int8:  # exact integer sums, as the kernel's int32
            out[:, s:s + block] = word_max.double().sum(dim=-1).float()
        else:
            out[:, s:s + block] = word_max.sum(dim=-1)
    return out


def _group_slots(r: int) -> int:
    """Region slots an image holds in the kernel's operand: R rounded up to
    a whole 64-row slab's 8, or, where R mod 8 is 1 or 2 past the first
    slab, rounded up to 2, and the kernel multiplies the last two slots in
    its 16-row tail pass (the tail layout; bf16 and int8 alike: both run
    faster so than through one more slab, tools/k1_variants.py)."""
    whole = r // _SLAB_SLOTS * _SLAB_SLOTS
    if whole and 0 < r - whole <= _TAIL_SLOTS:
        return whole + _TAIL_SLOTS
    return -(-r // _SLAB_SLOTS) * _SLAB_SLOTS


def _kernel_operands(im: torch.Tensor, words: torch.Tensor):
    """The operand layout of csrc/mrsw_kernel.cu, from prepared (N_im, R, D)
    images and the packed (n_words, D) caption words: (a, b), both 2-D
    row-major.

    ``a`` holds the images in groups of 8, rows ordered (group, region slot
    j, image s), R padded with zero rows to ``_group_slots(R)`` and N_im
    with zero images to a multiple of 8: row (g * slots + j) * 8 + s is
    region j of image 8g + s.
    ``b`` is the packed words (at least one row). Both pad D with zeros to
    a multiple of 128 bytes. The kernel excludes the padded slots (j >= R)
    from the max by index and writes no score for a padded image; the zero
    coordinates change no sum.
    """
    n_im, r, d = im.shape
    d_pad = (-d) % (_ROW_BYTES // im.element_size())
    slots = _group_slots(r)
    groups = -(-n_im // _IMAGE_GROUP)
    a = im.new_zeros(groups * _IMAGE_GROUP, slots, d + d_pad)
    a[:n_im, :r, :d] = im
    a = a.view(groups, _IMAGE_GROUP, slots, d + d_pad).transpose(1, 2).reshape(-1, d + d_pad)
    b = F.pad(words, (0, d_pad, 0, max(0, 1 - words.shape[0])))
    return a, b.contiguous()


def _launch(im: torch.Tensor, words: torch.Tensor, plan: _Plan,
            table: torch.Tensor) -> torch.Tensor:
    """Run csrc/mrsw_kernel.cu over ``plan`` on prepared CUDA operands."""
    if im.dtype not in _DTYPE_CODE or words.dtype != im.dtype:
        raise ValueError(f"the MrSw kernel takes bf16 or int8 operands, got "
                         f"{im.dtype}/{words.dtype}")
    n_im, r, d = im.shape
    n_cap = len(plan.caps)
    longest = int(plan.caps[:, 1].max()) if n_cap else 0
    if r > _MAX_ROWS or longest > _MAX_ROWS:
        raise ValueError(f"the MrSw kernel takes at most {_MAX_ROWS} regions and words, "
                         f"got {r} and {longest}")
    out = torch.empty(n_im, n_cap, dtype=torch.float32, device=im.device)
    if n_im == 0 or n_cap == 0:
        return out
    slots = _group_slots(r)
    a, b = _kernel_operands(im, words)
    lib = _kernel_library()
    with torch.cuda.device(im.device):
        stream = torch.cuda.current_stream(im.device).cuda_stream
        err = lib.mrsw_scores_launch(_DTYPE_CODE[im.dtype], a.data_ptr(), b.data_ptr(),
                                     table.data_ptr(), out.data_ptr(), n_im, r, slots, n_cap,
                                     len(plan.tiles), b.shape[0], a.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"MrSw kernel launch failed: {lib.mrsw_error_string(err).decode()}")
    profiling.count("k1.launches")
    profiling.count("mrsw.valid_slots", n_im * r)
    # the image operand's rows (8 x groups x slots): the layout, which K1
    # multiplies row for row, the last two slots of a tail layout in its tail pass
    profiling.count("mrsw.multiplied_slots", a.shape[0])
    return out


def mrsw_scores(im_set: torch.Tensor, s_seq: torch.Tensor, im_len: torch.Tensor,
                s_len: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(N_im, N_cap) MrSw scores: the CUDA kernel for CUDA tensors, the
    plain walk of the same plan for CPU tensors (see the module docstring)."""
    return _scores(im_set, s_seq, im_len, s_len, compute_dtype)


def mrsw_scores_plain(im_set: torch.Tensor, s_seq: torch.Tensor, im_len: torch.Tensor,
                      s_len: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The reference version of ``mrsw_scores`` on any device: the whole
    buffers prepared, then a blocked f32 matmul + max + sum. Its operations
    (2 x D x N_im x R x N_cap x W) are counted in ``mrsw.launched_ops``."""
    with torch.no_grad():
        im, cap, descale = _prepare(im_set, s_seq, im_len, s_len, compute_dtype)
        (n_im, r, d), (n_cap, w) = im.shape, cap.shape[:2]
        profiling.count("mrsw.launched_ops", 2 * d * n_im * r * n_cap * w)
        out = _plain_core(im, cap)
    return out * descale if descale is not None else out


def _scores(im_set, s_seq, im_len, s_len, compute_dtype, groups=None, lens=None) -> torch.Tensor:
    """Plan, gather and walk: K1 on CUDA tensors, ``_plain_walk`` on CPU
    ones. ``lens``: ``s_len`` already read to the host; ``groups``: a group
    id a caption, each group with its own int8 caption scale. The
    operations handed over (2 x D x N_im x R x the plan's tiles x their
    columns) are counted in ``mrsw.launched_ops``."""
    _check_dtype(compute_dtype)
    device = im_set.device
    if device.type == "cuda" and compute_dtype not in _DTYPE_CODE:
        raise ValueError("the MrSw kernel scores in bfloat16 or int8; f32 scoring on the "
                         "card is ops.alignment.score_all_pairs")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"mrsw_scores runs on cpu or cuda tensors, got {device}")
    n_im, s_im, d = im_set.shape
    w = s_seq.shape[1] - 3
    if device.type == "cuda":
        if s_im - 1 > _MAX_ROWS or w > _MAX_ROWS:
            raise ValueError(f"the MrSw kernel takes at most {_MAX_ROWS} regions and words, "
                             f"got {s_im - 1} and {w}")
        if compute_dtype == torch.int8 and w * d * 127 * 127 >= 2 ** 31:
            raise ValueError(f"int8 word sums of {w} words x D={d} could overflow int32")
    with torch.no_grad():
        im, words, descale, plan, table = _packed(im_set, s_seq, im_len, s_len, compute_dtype,
                                                  groups, lens)
        profiling.count("mrsw.launched_ops",
                        2 * d * n_im * im.shape[1] * len(plan.tiles) * plan.cols)
        core = _launch if device.type == "cuda" else _plain_walk
        out = core(im, words, plan, table)
    return out * descale if descale is not None else out


def _packed(im_set, s_seq, im_len, s_len, compute_dtype, groups=None, lens=None):
    """(im, words, descale, plan, table): the plan of the captions' word
    counts (``s_len`` read to the host unless ``lens`` has it), uploaded
    once, and the operands prepared along it (``_packed_operands``)."""
    if lens is None:
        lens = s_len.cpu().numpy()
    w = max(s_seq.shape[1] - 3, 0)
    plan = _plan(np.clip(np.asarray(lens, np.int64) - 3, 0, w))
    table = _table(plan, groups, im_set.device)
    im, words, descale = _packed_operands(im_set, s_seq, im_len, plan, table, compute_dtype,
                                          groups)
    return im, words, descale, plan, table


def caption_buckets(lens, w: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The caption-length rule of bucketed MrSw scoring, aladin_tpu's:
    (width (N,), bucket (N,), kept (K,)) of captions of ``lens`` tokens
    (special tokens included) in a buffer of ``w`` slots. A caption is
    ``min(ceil(max(len, 4) / 16) * 16, w)`` slots wide; widths holding
    under 4% of the captions merge into the next wider kept width, and the
    widest is always kept. ``bucket`` indexes ``kept``: the narrowest kept
    width that holds the caption."""
    width = np.minimum(-(-np.maximum(np.asarray(lens, np.int64), 4) // 16) * 16, w)
    uniq, count = np.unique(width, return_counts=True)
    kept = uniq[(count >= 0.04 * width.size) | (uniq == uniq[-1])]
    return width, np.searchsorted(kept, width), kept


def mrsw_scores_bucketed(im_set: torch.Tensor, s_seq: torch.Tensor, im_len: torch.Tensor,
                         s_len: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Length-bucketed MrSw scoring: one ``_scores`` call, after one read of
    the lengths to the host. K1's plan packs only valid words, so how the
    captions are grouped does not change its work, and bf16 (f32 on the
    CPU) scores equal ``mrsw_scores``'s bit for bit. The buckets of
    ``caption_buckets`` survive as int8's caption scales, one a bucket (as
    a call a bucket has them in aladin_tpu), so int8 agrees with
    unbucketed scoring only to within rounding.

    The call is the span ``mrsw.bucketed``, the scorer call inside it the
    span ``mrsw.call`` (``utils/profiling.py``).
    """
    with profiling.span("mrsw.bucketed"):
        lens = s_len.cpu().numpy()
        groups = caption_buckets(lens, s_seq.shape[1])[1] if compute_dtype == torch.int8 else None
        with profiling.span("mrsw.call"):
            return _scores(im_set, s_seq, im_len, s_len, compute_dtype, groups, lens)
