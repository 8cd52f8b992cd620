"""Fused all-heads self-attention with a recompute backward: the CUDA kernels,
their plain versions, and the autograd Function (mirrors
aladin_tpu/ops/pallas/attention_kernel.py).

``fused_attention(q, k, v, bias, seed, dropout_rate, train)`` has the
contract of ``aladin_tpu``'s: q, k, v (B, S, H, d) in the projection layout,
an additive f32 bias (B, Q, K) with Q = 1 (broadcast over the queries) or
Q = S, and ctx (B, S, H, d) = dropout(softmax(QK^T / sqrt(d) + bias)) V with
the probabilities rounded to v's dtype before the product and f32 sums. The
backward recomputes the probabilities, regenerates the same dropout mask
from the same seed and returns dq, dk, dv in q's dtype, computing in f32
and using the undropped probabilities in the softmax VJP; bias and seed get
no gradient. Then:

  * CUDA tensors launch ``csrc/attention_kernel.cu`` (d = 64, S <= 160;
    bf16 runs the tensor-core kernels, f32 the CUDA-core ones, whose
    backward needs S <= 142 for its shared memory; anything else raises);
  * CPU tensors run the plain PyTorch versions, ``attention_forward_plain``
    and ``attention_backward_plain``.

Dropout: the keep bit of element (b, h, q, k) is a counter-based hash of
(seed, b * heads_total + head_offset + h, q * S + k) in 32-bit integer
arithmetic (``keep_mask``), the same in the kernel and the plain version,
so the two agree with dropout on as well. By default ``heads_total`` is H
and ``head_offset`` 0 (the hash of (b * H + h)); a rank of a tensor-parallel
group that holds heads [offset, offset + H) of ``heads_total`` passes both,
and draws exactly the masks of those heads in the unsharded launch. keep =
bits >= uint32(rate * 2^32) and kept probabilities are scaled by
1 / (1 - rate), as in the JAX kernel. The mask is not the TPU
PRNG's: the same distribution, other draws.

The seed is an int or a one-element integer tensor; the kernels read it on
the card through a pointer (its low 32 bits), so a seed drawn on the card
(``models/bert_img.py``) changes on every replay of a CUDA graph that
captured the launch. An int seed on the card is wrapped in an int64 tensor
first; the backward reads the same tensor as the forward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from aladin_torch.ops.kernels import build

_KERNEL_SOURCE = "attention_kernel.cu"
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIM = 64  # the kernel's head width
MAX_SEQ = 160  # bf16: ten warps of 16 query rows; f32: five key columns per lane
MAX_SMEM = 232448  # the opt-in shared memory of one block on sm_90
_M32 = 0xFFFFFFFF


def _mul32(x, m: int):
    """(x * m) mod 2^32 for x in [0, 2^32) without leaving int64: m is split
    into 16-bit halves so no product exceeds 2^48."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """The kernel's 32-bit integer hash (csrc/attention_kernel.cu::mix32), on
    Python ints or int64 tensors holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _threshold(rate: float) -> int:
    return min(int(rate * 2 ** 32), _M32)


Seed = Union[int, torch.Tensor]


def keep_mask(seed: Seed, b: int, h: int, s: int, rate: float, device="cpu",
              heads_total: Optional[int] = None, head_offset: int = 0) -> torch.Tensor:
    """(B, H, S, S) bool keep mask of ``seed`` (an int or a one-element
    tensor): bits >= uint32(rate * 2^32) with
    bits = mix32(mix32(mix32(seed) ^ (b * heads_total + head_offset + h)) ^ (q * S + k)),
    ``heads_total`` H by default: heads [head_offset, head_offset + H) of a
    launch over ``heads_total`` heads."""
    ht = h if heads_total is None else int(heads_total)
    bh = (torch.arange(b, device=device, dtype=torch.int64).reshape(b, 1, 1, 1) * ht
          + int(head_offset)
          + torch.arange(h, device=device, dtype=torch.int64).reshape(1, h, 1, 1))
    qk = torch.arange(s * s, device=device, dtype=torch.int64).reshape(1, 1, s, s)
    seed = (seed.to(device=device, dtype=torch.int64).reshape(()) if torch.is_tensor(seed)
            else int(seed)) & _M32  # a tensor stays on its device: no sync
    key = _mix32(_mix32(seed) ^ bh)
    return _mix32(key ^ qk) >= _threshold(rate)


def _dropout_on(rate: float, train: bool) -> bool:
    return bool(train) and rate > 0.0


def _acc(t: torch.Tensor) -> torch.dtype:
    """The accumulation dtype: f32 (f64 for f64 inputs, for exact tests)."""
    return torch.promote_types(t.dtype, torch.float32)


def _probs(q, k, bias):
    """Undropped probabilities (B, H, S, S) and the (B, H, S, d) heads, in
    the accumulation dtype."""
    d, acc = q.shape[-1], _acc(q)
    qh, kh = (t.permute(0, 2, 1, 3).to(acc) for t in (q, k))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / d ** 0.5) + bias.to(acc)[:, None]
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True), qh, kh


def attention_forward_plain(q, k, v, bias, seed: Seed = 0, dropout_rate: float = 0.0,
                            train: bool = False, heads_total: Optional[int] = None,
                            head_offset: int = 0) -> torch.Tensor:
    """The forward kernel's arithmetic in PyTorch, on any device (f32
    accumulation; f64 for f64 inputs)."""
    b, s, h, _ = q.shape
    p, _, _ = _probs(q, k, bias)
    if _dropout_on(dropout_rate, train):
        keep = keep_mask(seed, b, h, s, dropout_rate, q.device, heads_total, head_offset)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), torch.zeros_like(p))
    ctx = torch.matmul(p.to(v.dtype).to(p.dtype), v.permute(0, 2, 1, 3).to(p.dtype))
    return ctx.permute(0, 2, 1, 3).to(q.dtype)


def attention_backward_plain(q, k, v, bias, g, seed: Seed = 0, dropout_rate: float = 0.0,
                             train: bool = False, heads_total: Optional[int] = None,
                             head_offset: int = 0):
    """The backward kernel's arithmetic in PyTorch: (dq, dk, dv) in q's dtype."""
    b, s, h, d = q.shape
    p, qh, kh = _probs(q, k, bias)
    vh, gh = (t.permute(0, 2, 1, 3).to(p.dtype) for t in (v, g))
    if _dropout_on(dropout_rate, train):
        keep = keep_mask(seed, b, h, s, dropout_rate, q.device, heads_total, head_offset)
        scale = 1.0 / (1.0 - dropout_rate)
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        dv = torch.matmul(torch.where(keep, p * scale, zero).transpose(-1, -2), gh)
        dp = torch.where(keep, torch.matmul(gh, vh.transpose(-1, -2)) * scale, zero)
    else:
        dv = torch.matmul(p.transpose(-1, -2), gh)
        dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * (1.0 / d ** 0.5)
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(t.permute(0, 2, 1, 3).to(q.dtype) for t in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    lib = build.load_library(_KERNEL_SOURCE)
    ptr, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.attn_fwd_launch.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                    i32, i32, ptr, u32, f32, f32, i32, ptr]
    lib.attn_fwd_launch.restype = i32
    lib.attn_bwd_launch.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                    i32, i32, i32, i32, ptr, u32, f32, f32, i32, ptr]
    lib.attn_bwd_launch.restype = i32
    lib.attn_smem_bytes.argtypes = [i32, i32, i32]
    lib.attn_smem_bytes.restype = ctypes.c_ulong
    lib.attn_error_string.argtypes = [i32]
    lib.attn_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, bias, backward: bool, heads_total: int, head_offset: int) -> None:
    """Raise for CUDA inputs the kernels do not take."""
    b, s, h, d = q.shape
    if head_offset < 0 or head_offset + h > heads_total:
        raise ValueError(f"heads [{head_offset}, {head_offset + h}) are not among "
                         f"heads_total={heads_total}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the attention kernel takes bf16 or f32 q/k/v of one dtype, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if d != HEAD_DIM:
        raise ValueError(f"the attention kernel takes head dim {HEAD_DIM}, got {d}")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"the attention kernel takes 1 <= S <= {MAX_SEQ}, got {s}")
    if bias.ndim != 3 or bias.shape[0] != b or bias.shape[2] != s or bias.shape[1] not in (1, s):
        raise ValueError(f"bias must be (B, 1 or S, S) = ({b}, 1|{s}, {s}), got {tuple(bias.shape)}")
    smem = _kernel_library().attn_smem_bytes(_DTYPE_CODE[q.dtype], int(backward), s)
    if smem > MAX_SMEM:
        raise ValueError(f"S={s} in {q.dtype} needs {smem} bytes of shared memory "
                         f"(limit {MAX_SMEM})")


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address, as the bf16 kernels'
    16-byte cp.async staging needs (a copy only for an offset view)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def seed_tensor(seed: Seed, device) -> torch.Tensor:
    """``seed`` as the kernels read it: a 0-d int64 tensor on ``device``
    (an int is wrapped, keeping its low 32 bits, by a fill on the device:
    no copy from host memory, so the host does not wait for the card; a
    tensor on the device is used as it is, so a seed drawn there is not
    copied)."""
    if not torch.is_tensor(seed):
        return torch.full((), int(seed) & _M32, dtype=torch.int64, device=device)
    if seed.numel() != 1 or seed.device != torch.device(device) or seed.is_floating_point():
        raise ValueError(f"the seed must be one integer on {device}, got {seed.dtype} "
                         f"{tuple(seed.shape)} on {seed.device}")
    return seed.reshape(()) if seed.dtype == torch.int64 else seed.reshape(()).long()


def _launch_args(q, bias, seed, dropout_rate, train, heads_total, head_offset, stream):
    """The launch's arguments after the tensors: shape, the hash's head
    numbering, seed pointer (null without dropout: the kernels do not read
    it), threshold, scales."""
    b, s, h, d = q.shape
    on = _dropout_on(dropout_rate, train)
    scale = 1.0 / (1.0 - dropout_rate) if on else 1.0
    seed_ptr = seed_tensor(seed, q.device).data_ptr() if on else None
    return (b, s, h, d, bias.shape[1], heads_total, head_offset, seed_ptr,
            _threshold(dropout_rate) if on else 0, scale, 1.0 / d ** 0.5, int(on), stream)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"attention {what} kernel launch failed: "
                           f"{lib.attn_error_string(err).decode()}")


def attention_forward(q, k, v, bias, seed: Seed = 0, dropout_rate: float = 0.0,
                      train: bool = False, heads_total: Optional[int] = None,
                      head_offset: int = 0) -> torch.Tensor:
    """ctx (B, S, H, d): the forward kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_forward_plain(q, k, v, bias, seed, dropout_rate, train, heads_total,
                                       head_offset)
    if q.device.type != "cuda":
        raise ValueError(f"fused attention runs on cpu or cuda tensors, got {q.device}")
    q, k, v = (_staged(t) for t in (q, k, v))
    bias = bias.float().contiguous()
    heads_total = q.shape[2] if heads_total is None else int(heads_total)
    _check(q, k, v, bias, False, heads_total, int(head_offset))
    out = torch.empty_like(q)
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attn_fwd_launch(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  bias.data_ptr(), out.data_ptr(),
                                  *_launch_args(q, bias, seed, dropout_rate, train, heads_total,
                                                int(head_offset), stream))
    _raise_on(lib, err, "forward")
    attention_forward.launches += 1
    return out


attention_forward.launches = 0  # kernel launches; the plain version does not count


def attention_backward(q, k, v, bias, g, seed: Seed = 0, dropout_rate: float = 0.0,
                       train: bool = False, heads_total: Optional[int] = None,
                       head_offset: int = 0):
    """(dq, dk, dv): the backward kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, bias, g, seed, dropout_rate, train,
                                        heads_total, head_offset)
    if q.device.type != "cuda":
        raise ValueError(f"fused attention runs on cpu or cuda tensors, got {q.device}")
    q, k, v = (_staged(t) for t in (q, k, v))
    g = _staged(g.to(q.dtype))
    bias = bias.float().contiguous()
    heads_total = q.shape[2] if heads_total is None else int(heads_total)
    _check(q, k, v, bias, True, heads_total, int(head_offset))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attn_bwd_launch(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  bias.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                  dv.data_ptr(),
                                  *_launch_args(q, bias, seed, dropout_rate, train, heads_total,
                                                int(head_offset), stream))
    _raise_on(lib, err, "backward")
    attention_backward.launches += 1
    return dq, dk, dv


attention_backward.launches = 0


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, dropout_rate, train, heads_total, head_offset):
        if q.device.type == "cuda" and _dropout_on(dropout_rate, train):
            seed = seed_tensor(seed, q.device)  # one tensor for the forward and the backward
        if torch.is_tensor(seed):
            ctx.save_for_backward(q, k, v, bias, seed)
        else:
            ctx.save_for_backward(q, k, v, bias)
        ctx.args = (seed if not torch.is_tensor(seed) else None, dropout_rate, train,
                    heads_total, head_offset)
        return attention_forward(q, k, v, bias, seed, dropout_rate, train, heads_total,
                                 head_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, *seed = ctx.saved_tensors
        int_seed, dropout_rate, train, heads_total, head_offset = ctx.args
        seed = seed[0] if seed else int_seed
        with torch.autocast(q.device.type, enabled=False):
            dq, dk, dv = attention_backward(q, k, v, bias, g, seed, dropout_rate, train,
                                            heads_total, head_offset)
        return dq, dk, dv, None, None, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                    seed: Optional[Seed] = None, dropout_rate: float = 0.0,
                    train: bool = False, heads_total: Optional[int] = None,
                    head_offset: int = 0) -> torch.Tensor:
    """ctx (B, S, H, d) = dropout(softmax(QK^T / sqrt(d) + bias)) V,
    differentiable in q, k, v. ``seed`` (an int, or a one-element integer
    tensor on q's device) must change from call to call in training; the
    backward regenerates the forward's mask from it. ``heads_total`` /
    ``head_offset``: the H heads are [head_offset, head_offset + H) of a
    layer of ``heads_total`` heads (a tensor-parallel rank's), and draw
    those heads' masks (default: all of H, from 0)."""
    with torch.autocast(q.device.type, enabled=False):
        return _FusedAttention.apply(q, k, v, bias, 0 if seed is None else seed,
                                     float(dropout_rate), bool(train),
                                     q.shape[2] if heads_total is None else int(heads_total),
                                     int(head_offset))
