"""Kimi Delta Attention's recurrence (``models/kimi_linear.py``): the
prefill over documents packed end to end (K5) and the decode step (K6),
CUDA C++ kernels on the card (``csrc/kda_kernel.cu``, whose comment gives
their design) and their plain versions on the CPU.

Both take a KDA layer's raw projections, before the short convolutions:
``q``, ``k``, ``v`` (N, H x d) in the model's dtype (d = d_k = d_v, 128 in
Kimi-Linear), ``f`` (N, H x d) the decay's low-rank projection before its
bias and softplus, ``b`` (N, H) the logit of beta. Per head n, channel c
and token t (``conv`` causal and depthwise, width 4, weight ``w[c, 0..3]``,
``w[c, 3]`` on the token itself):

    q_t = silu(conv_q)_t / sqrt(|silu(conv_q)_t|^2 + 1e-6) / sqrt(d)
    k_t = silu(conv_k)_t / sqrt(|silu(conv_k)_t|^2 + 1e-6)
    v_t = silu(conv_v)_t
    log alpha_t[c] = -exp(A_log[n]) softplus(f_t[c] + dt_bias[c])
    beta_t = sigmoid(b_t[n])
    S <- Diag(alpha_t) S;  S <- S + beta_t k_t (v_t - S^T k_t)^T;  o_t = S^T q_t

with S (d x d) in float32, zero at a document's first token, and the
convolutions starting from zeros there. A state buffer holds S transposed,
(B, H, d_v, d_k): a row of it is one value column's key channels, which
the kernels read and write along contiguous memory. The convolutions, the
norms, the decay and beta are computed inside the kernels from the raw
projections, in float32, and never stored: the kernels read each token's
inputs once (q, k, v, f, b in bf16) and write o once.

K5 (``kda_prefill``; no TPU kernel: the JAX package has no linear
attention) runs a warp a (document, head, block of 16 value columns), four
such warps a block, the longest documents first: the state's block stays
in registers along the document, and at the document's end the warp
writes it into the decode cache's row of that document with the raw
projections of the last 3 tokens (the convolutions' tails). Documents are
given by ``cu_seqlens`` on the card, with no pad token. Its bound on an
H100 is bytes (per token and head, 4 x 128 values in and 128 out against
4 x 128 x 128 multiply-adds), but a document is a chain of dependent token
steps on the CUDA cores, so the longest document and the cores' rate set
its time; the chunked tensor-core (WY) form is the next step.

K6 (``kda_step``) feeds one token a row: a block of eight warps a (row,
head) holds the whole 128 x 128 state, reads it and its convolution tails
(3 earlier raw tokens) and writes both back in place, so a CUDA graph
replays it with no host read. Its bound is the state's bytes, read and
written once.

Counters (``utils/profiling.py``): ``k5.launches``, ``k6.launches``, one
a call that launched a kernel (a CUDA graph's replays are not counted).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from aladin_torch.ops.kernels import build
from aladin_torch.utils import profiling

CONV = 4  # the short convolutions' width
EPS = 1e-6  # the q / k L2 norms'
HEAD = 128  # the kernels' d_k = d_v
_KERNEL_SOURCE = "kda_kernel.cu"


class Weights(NamedTuple):
    """A KDA layer's per-channel parameters as the kernels take them:
    ``conv`` (3, D, 4) for q, k, v, ``a_log`` (H,), ``dt_bias`` (D,)."""

    conv: torch.Tensor
    a_log: torch.Tensor
    dt_bias: torch.Tensor


def _features(q, k, v, f, b, w: Weights, window: Optional[torch.Tensor] = None):
    """The recurrence's inputs in float32 for one document's tokens in order
    (plain form): q, k, v (T, H, d) after the convolutions (``window``
    (3, 3D): the raw q | k | v of the 3 tokens before the first; zeros if
    None), SiLU and the norms; log alpha (T, H, d); beta (T, H); and the
    last 3 raw rows (3, 3D), the next window."""
    t, d = q.shape
    h = b.shape[1]
    dk = d // h
    raw = torch.cat([q, k, v], dim=1).float()
    prev = raw.new_zeros(CONV - 1, 3 * d) if window is None else window.float()
    seq = torch.cat([prev, raw])
    wt = w.conv.float().reshape(3 * d, CONV)
    conv = sum(seq[i:i + t] * wt[:, i] for i in range(CONV))
    y = F.silu(conv).reshape(t, 3, h, dk)
    qf = y[:, 0] * torch.rsqrt(y[:, 0].pow(2).sum(-1, keepdim=True) + EPS) / math.sqrt(dk)
    kf = y[:, 1] * torch.rsqrt(y[:, 1].pow(2).sum(-1, keepdim=True) + EPS)
    g = (-torch.exp(w.a_log.float())[:, None]
         * F.softplus(f.float() + w.dt_bias.float()).reshape(t, h, dk))
    return qf, kf, y[:, 2], g, torch.sigmoid(b.float()), seq[t:]


def recurrence_plain(q, k, v, g, beta, state: torch.Tensor) -> torch.Tensor:
    """Token by token from ``state`` (H, d, d) float32, updated in
    place: o (T, H, d) float32."""
    out = []
    for t in range(q.shape[0]):
        state.mul_(torch.exp(g[t])[..., None])
        u = v[t] - torch.einsum("hkv,hk->hv", state, k[t])
        state.add_(beta[t][:, None, None] * k[t][..., None] * u[:, None, :])
        out.append(torch.einsum("hkv,hk->hv", state, q[t]))
    return torch.stack(out)


def kda_prefill_plain(q, k, v, f, b, w: Weights, cu_seqlens, rows, state, tails):
    """K5's plain version (module doc), document by document."""
    o = torch.empty_like(q)
    cu = cu_seqlens.tolist()
    for d, row in enumerate(rows.tolist()):
        s = slice(cu[d], cu[d + 1])
        qf, kf, vf, g, beta, window = _features(q[s], k[s], v[s], f[s], b[s], w)
        state[row].zero_()
        o[s] = recurrence_plain(qf, kf, vf, g, beta,
                                state[row].transpose(-1, -2)).flatten(1).to(o.dtype)
        tails[row] = window.to(tails.dtype)
    return o


def kda_step_plain(q, k, v, f, b, w: Weights, state, tails):
    """K6's plain version: one token a row, state and tails in place."""
    o = torch.empty_like(q)
    for r in range(q.shape[0]):
        qf, kf, vf, g, beta, window = _features(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                                f[r:r + 1], b[r:r + 1], w, tails[r])
        o[r] = recurrence_plain(qf, kf, vf, g, beta,
                                state[r].transpose(-1, -2)).flatten().to(o.dtype)
        tails[r] = window.to(tails.dtype)
    return o


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    lib = build.load_library(_KERNEL_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kda_prefill_launch.argtypes = [p] * 14 + [i, i, f, p]
    lib.kda_prefill_launch.restype = i
    lib.kda_step_launch.argtypes = [p] * 11 + [i, i, f, p]
    lib.kda_step_launch.restype = i
    lib.kda_error_string.argtypes = [i]
    lib.kda_error_string.restype = ctypes.c_char_p
    return lib


def _launched(err: int, lib, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.kda_error_string(err).decode()}")


def _check(q, k, v, f, b, w: Weights, state, tails, name: str) -> int:
    """H of a launch's operands; raises on what the kernels do not take."""
    n, d = q.shape
    h = b.shape[-1]
    if h * HEAD != d:
        raise ValueError(f"{name} takes heads of {HEAD}, got {d} channels over {h} heads")
    for name_, x, shape in (("q", q, (n, d)), ("k", k, (n, d)), ("v", v, (n, d)),
                            ("f", f, (n, d)), ("b", b, (n, h)), ("conv", w.conv, (3, d, CONV)),
                            ("tails", tails, (tails.shape[0], CONV - 1, 3 * d))):
        if x.dtype != torch.bfloat16 or x.shape != shape or not x.is_contiguous() \
                or x.device != q.device or x.data_ptr() % 8:
            raise ValueError(f"{name}: {name_} must be contiguous bfloat16 {shape} on {q.device}")
    for name_, x, shape in (("A_log", w.a_log, (h,)), ("dt_bias", w.dt_bias, (d,)),
                            ("state", state, (state.shape[0], h, HEAD, HEAD))):
        if x.dtype != torch.float32 or x.shape != shape or not x.is_contiguous() \
                or x.device != q.device or x.data_ptr() % 16:
            raise ValueError(f"{name}: {name_} must be contiguous float32 {shape} on {q.device}")
    return h


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def kda_prefill(q, k, v, f, b, w: Weights, cu_seqlens: torch.Tensor, rows: torch.Tensor,
                state: torch.Tensor, tails: torch.Tensor) -> torch.Tensor:
    """K5 over documents packed end to end: o (N, D) in q's dtype; each
    document's final state into ``state[rows[d]]`` and its last 3 raw
    tokens into ``tails[rows[d]]`` (module doc). ``cu_seqlens`` (docs + 1,)
    int32 and ``rows`` (docs,) int64 on q's device. CPU tensors run the
    plain version."""
    if q.device.type == "cpu":
        return kda_prefill_plain(q, k, v, f, b, w, cu_seqlens, rows, state, tails)
    h = _check(q, k, v, f, b, w, state, tails, "kda_prefill")
    docs = rows.shape[0]
    if cu_seqlens.dtype != torch.int32 or cu_seqlens.shape != (docs + 1,) \
            or rows.dtype != torch.int64 or not rows.is_contiguous() \
            or not cu_seqlens.is_contiguous() or {cu_seqlens.device, rows.device} != {q.device}:
        raise ValueError(f"kda_prefill: cu_seqlens ({docs + 1},) int32 and rows ({docs},) int64 "
                         f"on {q.device} expected")
    o = torch.empty_like(q)
    order = torch.argsort(cu_seqlens[1:] - cu_seqlens[:-1], descending=True)
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        _launched(lib.kda_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), f.data_ptr(), b.data_ptr(),
            w.conv.data_ptr(), w.a_log.data_ptr(), w.dt_bias.data_ptr(), cu_seqlens.data_ptr(),
            rows.data_ptr(), order.data_ptr(), o.data_ptr(), state.data_ptr(), tails.data_ptr(),
            docs, h, EPS, _stream(q.device)), lib, "kda_prefill")
    profiling.count("k5.launches")
    return o


def kda_step(q, k, v, f, b, w: Weights, state: torch.Tensor, tails: torch.Tensor) -> torch.Tensor:
    """K6: one token a row (B rows), ``state`` (B, H, d, d) float32 (S
    transposed) and ``tails`` (B, 3, 3D) updated in place; o (B, D) in q's
    dtype. CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return kda_step_plain(q, k, v, f, b, w, state, tails)
    h = _check(q, k, v, f, b, w, state, tails, "kda_step")
    if state.shape[0] != q.shape[0] or tails.shape[0] != q.shape[0]:
        raise ValueError(f"kda_step: a state and tails a row of q ({q.shape[0]}) expected")
    o = torch.empty_like(q)
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        _launched(lib.kda_step_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), f.data_ptr(), b.data_ptr(),
            w.conv.data_ptr(), w.a_log.data_ptr(), w.dt_bias.data_ptr(), o.data_ptr(),
            state.data_ptr(), tails.data_ptr(), q.shape[0], h, EPS, _stream(q.device)),
            lib, "kda_step")
    if not torch.cuda.is_current_stream_capturing():
        profiling.count("k6.launches")  # a CUDA graph's replays are counted by the decoder
    return o
