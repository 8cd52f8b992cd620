"""Fused MrSw all-pairs scoring: the CUDA kernel, its plain version, and the
length-bucketed scorer (mirrors aladin_tpu/ops/pallas/alignment_kernel.py).

``mrsw_scores`` has the contract of ``aladin_tpu``'s ``mrsw_scores_pallas``:
UN-stripped token sets with lengths that include the special tokens, and a
(N_im, N_cap) f32 result ``score[i, c] = sum_w max_r <im[i, r], cap[c, w]>``.
In torch it l2-normalises (eps 1e-12), strips, zeroes padded regions and
words, and casts to the operand type; int8 builds per-tensor scales
``127 / max(max|x|, 1e-6)``, rounds and clips to +-127, and multiplies the
kernel's integer scores by ``1 / (s_im * s_cap)``. Then:

  * a CUDA tensor launches ``csrc/mrsw_kernel.cu`` (bf16 or int8 operands;
    f32 raises, since the kernel has no f32 path); a failed build or launch
    raises;
  * a CPU tensor runs the plain PyTorch version, ``mrsw_scores_plain``.

The plain version multiplies the (bf16-rounded, or int8) operands in f32
and reduces exactly as the kernel does; int8 dot products are exact integers
in f32 (768 * 127^2 < 2^24) and the word sums are taken in f64, so they
equal the kernel's int32 sums.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from aladin_torch.ops.alignment import strip_special_tokens
from aladin_torch.ops.kernels import build
from aladin_torch.ops.masking import valid_mask
from aladin_torch.ops.similarity import l2norm
from aladin_torch.utils import profiling

_KERNEL_SOURCE = "mrsw_kernel.cu"
_DTYPE_CODE = {torch.bfloat16: 0, torch.int8: 1}
_MAX_ROWS = 128  # the kernel's limit: at most 128 region rows / word columns
_IMAGE_GROUP = 8  # images interleaved in one group of the kernel's image operand
_SLOT_MULTIPLE = 8  # region slots per image are padded to a multiple of this
_WORD_GROUP = 16  # words per caption are padded to a multiple of this (one sum tree)
_ROW_BYTES = 128  # bytes of D the kernel loads per row and stage
_PLAIN_BLOCK_ELEMS = 64 << 20  # f32 alignment elements per plain-version block


def _prepare(im_set, s_seq, im_len, s_len, compute_dtype):
    """Normalise, strip, zero the padding and cast: (im, cap, descale)."""
    if compute_dtype not in (torch.bfloat16, torch.int8, torch.float32):
        raise ValueError(f"compute_dtype must be bfloat16, int8 or float32, got {compute_dtype}")
    im = l2norm(im_set.float(), eps=1e-12)
    cap = l2norm(s_seq.float(), eps=1e-12)
    im, cap, im_len, s_len = strip_special_tokens(im, cap, im_len, s_len)
    zero = torch.zeros((), dtype=im.dtype, device=im.device)
    im = torch.where(valid_mask(im_len, im.shape[1])[:, :, None], im, zero)
    cap = torch.where(valid_mask(s_len, cap.shape[1])[:, :, None], cap, zero)
    if compute_dtype == torch.int8:
        s_im = 127.0 / torch.clamp(im.abs().amax(), min=1e-6)
        s_cap = 127.0 / torch.clamp(cap.abs().amax(), min=1e-6)
        im = torch.clamp(torch.round(im * s_im), -127, 127).to(torch.int8)
        cap = torch.clamp(torch.round(cap * s_cap), -127, 127).to(torch.int8)
        return im, cap, 1.0 / (s_im * s_cap)
    return im.to(compute_dtype), cap.to(compute_dtype), None


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


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    lib = build.load_library(_KERNEL_SOURCE)
    lib.mrsw_scores_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mrsw_scores_launch.restype = ctypes.c_int
    lib.mrsw_error_string.argtypes = [ctypes.c_int]
    lib.mrsw_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_operands(im: torch.Tensor, cap: torch.Tensor):
    """The operand layout of csrc/mrsw_kernel.cu, from prepared (N_im, R, D)
    and (N_cap, W, D) operands: (a, b), both 2-D row-major.

    ``a`` holds the images in groups of 8, rows ordered (group, region slot
    j, image s), R padded with zero rows to a multiple of 8 and N_im with
    zero images to a multiple of 8: row (g * R8 + j) * 8 + s is region j of
    image 8g + s. ``b`` holds the captions with W padded with zero words to
    a multiple of 16. Both pad D with zeros to a multiple of 128 bytes. The
    kernel excludes the padded slots (j >= R) from the max by index and
    writes no score for a padded image; zero words and coordinates change no
    sum.
    """
    n_im, r, d = im.shape
    n_cap, w, _ = cap.shape
    d_pad = (-d) % (_ROW_BYTES // im.element_size())
    r8 = -(-r // _SLOT_MULTIPLE) * _SLOT_MULTIPLE
    w16 = -(-w // _WORD_GROUP) * _WORD_GROUP
    groups = -(-n_im // _IMAGE_GROUP)
    a = im.new_zeros(groups * _IMAGE_GROUP, r8, d + d_pad)
    a[:n_im, :r, :d] = im
    a = a.view(groups, _IMAGE_GROUP, r8, d + d_pad).transpose(1, 2).reshape(-1, d + d_pad)
    if w16 != w or d_pad:
        cap = F.pad(cap, (0, d_pad, 0, w16 - w))
    return a, cap.reshape(-1, d + d_pad).contiguous()


def _launch(im: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """Run csrc/mrsw_kernel.cu on prepared CUDA operands."""
    if im.dtype not in _DTYPE_CODE or cap.dtype != im.dtype:
        raise ValueError(f"the MrSw kernel takes bf16 or int8 operands, got {im.dtype}/{cap.dtype}")
    n_im, r, d = im.shape
    n_cap, w, _ = cap.shape
    if r > _MAX_ROWS or w > _MAX_ROWS:
        raise ValueError(f"the MrSw kernel takes at most {_MAX_ROWS} regions and words, "
                         f"got {r} and {w}")
    if im.dtype == torch.int8 and w * d * 127 * 127 >= 2 ** 31:
        raise ValueError(f"int8 word sums of {w} words x D={d} could overflow int32")
    out = torch.empty(n_im, n_cap, dtype=torch.float32, device=im.device)
    if n_im == 0 or n_cap == 0:
        return out
    a, b = _kernel_operands(im, cap)
    lib = _kernel_library()
    with torch.cuda.device(im.device):
        stream = torch.cuda.current_stream(im.device).cuda_stream
        err = lib.mrsw_scores_launch(_DTYPE_CODE[im.dtype], a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), n_im, r, n_cap, w, a.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"MrSw kernel launch failed: {lib.mrsw_error_string(err).decode()}")
    profiling.count("k1.launches")
    return out


def mrsw_scores(im_set: torch.Tensor, s_seq: torch.Tensor, im_len: torch.Tensor,
                s_len: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(N_im, N_cap) MrSw scores: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (see the module docstring)."""
    device = im_set.device
    if device.type == "cuda" and compute_dtype not in _DTYPE_CODE:
        raise ValueError("the MrSw kernel scores in bfloat16 or int8; f32 scoring on the "
                         "card is ops.alignment.score_all_pairs")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"mrsw_scores runs on cpu or cuda tensors, got {device}")
    core = _launch if device.type == "cuda" else _plain_core
    return _scores(core, im_set, s_seq, im_len, s_len, compute_dtype)


def mrsw_scores_plain(im_set: torch.Tensor, s_seq: torch.Tensor, im_len: torch.Tensor,
                      s_len: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version of ``mrsw_scores`` on any device: the same
    preparation, then a blocked f32 matmul + max + sum."""
    return _scores(_plain_core, im_set, s_seq, im_len, s_len, compute_dtype)


def _scores(core, im_set, s_seq, im_len, s_len, compute_dtype) -> torch.Tensor:
    """``core`` on the prepared operands, whose operations
    (2 x D x N_im x R x N_cap x W) are counted in ``mrsw.launched_ops``."""
    with torch.no_grad():
        im, cap, descale = _prepare(im_set, s_seq, im_len, s_len, compute_dtype)
        (n_im, r, d), (n_cap, w) = im.shape, cap.shape[:2]
        profiling.count("mrsw.launched_ops", 2 * d * n_im * r * n_cap * w)
        out = core(im, cap)
    return out * descale if descale is not None else out


def _merge_slivers(widths: np.ndarray, min_count: float) -> list:
    """Bucket widths to keep: every width holding >= min_count members, plus
    the widest; members of a dropped width move up to the next kept one
    (in place)."""
    uniq = np.sort(np.unique(widths))
    keep = [int(u) for u in uniq if int((widths == u).sum()) >= min_count]
    if not keep or keep[-1] != int(uniq[-1]):
        keep.append(int(uniq[-1]))
    for i, u in enumerate(widths):
        widths[i] = next(k for k in keep if k >= u)
    return keep


def mrsw_scores_bucketed(im_set: torch.Tensor, s_seq: torch.Tensor, im_len: torch.Tensor,
                         s_len: torch.Tensor, *, bucket_multiple: int = 16,
                         min_bucket_frac: float = 0.04, scorer=None, bucket_images: bool = False,
                         image_bucket_multiple: int = 8, **kernel_kw) -> torch.Tensor:
    """Length-bucketed MrSw scoring, one ``scorer`` call per bucket.

    Caption axis: captions are grouped by ceil(max(len, 4)/16)*16 slots
    (capped at the buffer), each bucket is scored on its columns sliced to
    that width, and the columns go back to corpus order. The dropped slots
    were zeroed words, so float scores are identical; int8 scales are per
    call and therefore per bucket, so int8 agrees only to within rounding.

    Image axis (``bucket_images``, off by default as in aladin_tpu): rows
    are grouped by ceil((stripped + 1)/8)*8 region slots, capped at the
    buffer, so every image shorter than the buffer keeps at least one zero
    row and with it the reference's zero floor.

    Buckets holding fewer than ``min_bucket_frac`` of their axis merge into
    the next wider one. ``scorer`` defaults to ``mrsw_scores(**kernel_kw)``.

    The call is the span ``mrsw.bucketed``, each scorer call inside it the
    span ``mrsw.call`` (``utils/profiling.py``).
    """
    with profiling.span("mrsw.bucketed"):
        return _bucketed(im_set, s_seq, im_len, s_len, bucket_multiple, min_bucket_frac, scorer,
                         bucket_images, image_bucket_multiple, kernel_kw)


def _bucketed(im_set, s_seq, im_len, s_len, bucket_multiple, min_bucket_frac, scorer,
              bucket_images, image_bucket_multiple, kernel_kw) -> torch.Tensor:
    n_cap, w, _ = s_seq.shape
    n_im = im_set.shape[0]
    device = im_set.device

    if bucket_images and n_im > 1:
        r_buf = im_set.shape[1]
        stripped = np.maximum(im_len.cpu().numpy() - 1, 1)
        iw = np.minimum(
            np.ceil((stripped + 1) / image_bucket_multiple).astype(np.int64) * image_bucket_multiple,
            r_buf - 1,
        )
        keep_i = _merge_slivers(iw, min_bucket_frac * n_im)
        if not (len(keep_i) == 1 and keep_i[0] == r_buf - 1):
            row_blocks, row_order = [], []
            for width in keep_i:
                ridx = np.nonzero(iw == width)[0]
                if ridx.size == 0:
                    continue
                t = torch.as_tensor(ridx, device=device)
                # slot 0 (the stripped special slot) + width region slots
                row_blocks.append(_bucketed(
                    im_set.index_select(0, t)[:, :width + 1], s_seq,
                    im_len.index_select(0, t), s_len, bucket_multiple, min_bucket_frac, scorer,
                    False, image_bucket_multiple, kernel_kw).float())
                row_order.append(ridx)
            inv = np.empty(n_im, np.int64)
            inv[np.concatenate(row_order)] = np.arange(n_im)
            return torch.cat(row_blocks, dim=0)[torch.as_tensor(inv, device=device)]

    widths = np.minimum(
        np.ceil(np.maximum(s_len.cpu().numpy(), 4) / bucket_multiple).astype(np.int64)
        * bucket_multiple, w,
    )
    keep = _merge_slivers(widths, min_bucket_frac * n_cap)
    if scorer is None:
        scorer = functools.partial(mrsw_scores, **kernel_kw)
    if len(keep) == 1 and keep[0] == w:
        with profiling.span("mrsw.call"):
            return scorer(im_set, s_seq, im_len, s_len)

    out = torch.zeros(n_im, n_cap, dtype=torch.float32, device=device)
    for width in keep:
        idx = np.nonzero(widths == width)[0]
        if idx.size == 0:
            continue
        t = torch.as_tensor(idx, device=device)
        caps, lens = s_seq.index_select(0, t)[:, :width], s_len.index_select(0, t)
        with profiling.span("mrsw.call"):
            got = scorer(im_set, caps, im_len, lens)
        out[:, t] = got.float()
    return out
