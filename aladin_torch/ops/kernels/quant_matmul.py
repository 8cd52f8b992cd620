"""W8A8 int8 GEMM with a fused epilogue: the CUDA kernels, their plain
versions, and the dense wrapper (mirrors aladin_tpu/ops/pallas/quant_matmul.py).

Two entries, one GEMM (``csrc/quant_matmul.cu``):

  * ``w8a8_matmul(xq, xscale, wq, wscale, bias)``: int8 activations
    quantized upstream (replaces ``_kernel`` via ``w8a8_matmul``);
  * ``w8a8_matmul_dynx(x, wq, wscale, bias)``: bf16 / f32 activations,
    quantized per row over the full K (replaces ``_kernel_dynx`` via
    ``w8a8_matmul_dynx``), with the scale ``max(absmax, 1e-8) * (1/127)``
    by reciprocal multiply, as the TPU kernel does, where
    ``quantize_rowwise`` divides: the two scales can differ by one f32 ulp.
    On the card that is two launches on the stream: the quantize kernel
    (``w8a8_quantize``, each row once, into int8 scratch) and the GEMM.

Both compute ``y = act(acc * xscale * wscale + bias)`` with ``acc`` the
exact int32 product over the whole K and the epilogue in f32, each product
and the add rounded on their own; ``act`` is None, "gelu" (exact erf) or
"gelu_tanh". Layouts: x (M, K), weights in the nn.Linear layout wq (N, K)
int8 with per-output-channel scales wscale (N,) f32, bias (N,) f32 or None,
y (M, N) bf16 or f32.

The GEMM is a persistent Hopper kernel: a TMA producer feeds 128-row x and
128-row weight tiles, 128 bytes of K a stage, to two warpgroups running
``wgmma`` s8; the epilogue works on the accumulator registers and writes y
in 16-byte pieces (the source note of ``csrc/quant_matmul.cu`` has the
design, the bound and the tile width's reason).

  * CUDA tensors launch the kernels; inputs they cannot take (dtypes, K not
    a multiple of 16 or above 1536) raise, and a failed build or launch
    raises;
  * CPU tensors run the plain versions, ``w8a8_matmul_plain`` and
    ``w8a8_matmul_dynx_plain``: the int8 product exactly in int32, then the
    same epilogue in torch ops.

Each entry counts its calls that reached the card in ``utils/profiling.py``
(``k4.launches``, ``k4.quantize_launches``, ``k4_dynx.launches``): one for
``w8a8_matmul``, and one for ``w8a8_matmul_dynx`` though it is two kernel
launches (the quantize and the GEMM).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from aladin_torch.ops.kernels import build
from aladin_torch.utils import profiling

_KERNEL_SOURCE = "quant_matmul.cu"
ACTIVATIONS = (None, "gelu", "gelu_tanh")
_ACT_CODE = {None: 0, "gelu": 1, "gelu_tanh": 2}
_OUT_CODE = {torch.bfloat16: 0, torch.float32: 1}
_X_CODE = {torch.bfloat16: 0, torch.float32: 1}
MAX_K = 1536  # the quantize kernel holds a row in registers (48 values a lane)
_INV_127 = float(np.float32(1.0 / 127.0))  # the f32 constant _kernel_dynx multiplies by
_SQRT_HALF = 0.7071067811865476
_GELU_TANH_C = 0.7978845608028654  # sqrt(2 / pi)


def quantize_rowwise(x: torch.Tensor, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 along ``dim`` (aladin_tpu/models/quant.py::
    quantize_rowwise): ``scale = max(absmax, 1e-8) / 127`` by division,
    ``q = clip(round_half_even(x / scale), -127, 127)``; zero rows stay 0.
    As there, the absmax and its floor take x's dtype, the rest f32."""
    absmax = torch.clamp(x.abs().amax(dim=dim, keepdim=True), min=1e-8)
    scale = absmax.float() / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_rowwise_dynx(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dynx kernel's per-row quantize of the last axis: the same as
    ``quantize_rowwise`` but with ``scale = max(absmax, 1e-8) * f32(1/127)``."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) * _INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _check_activation(activation) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r} ({ACTIVATIONS})")


def _epilogue_plain(acc, xscale, wscale, bias, activation, out_dtype):
    y = acc.float() * xscale.reshape(-1, 1).float() * wscale.reshape(1, -1).float()
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    if activation == "gelu":
        y = 0.5 * y * (1.0 + torch.erf(y * _SQRT_HALF))
    elif activation == "gelu_tanh":
        y = 0.5 * y * (1.0 + torch.tanh(_GELU_TANH_C * (y + 0.044715 * y * y * y)))
    return y.to(out_dtype)


def w8a8_matmul_plain(xq, xscale, wq, wscale, bias=None, *, activation=None,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch on any device: the int8 product
    exactly (int32 on the CPU; f64 on the card, which has no integer matmul
    and holds every such sum exactly), then the f32 epilogue."""
    _check_activation(activation)
    acc_dtype = torch.int32 if xq.device.type == "cpu" else torch.float64
    acc = torch.matmul(xq.to(acc_dtype), wq.to(acc_dtype).T)
    return _epilogue_plain(acc, xscale, wscale, bias, activation, out_dtype)


def w8a8_matmul_dynx_plain(x, wq, wscale, bias=None, *, activation=None,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """The dynx kernel's arithmetic in PyTorch: ``quantize_rowwise_dynx``
    then ``w8a8_matmul_plain``."""
    xq, xscale = quantize_rowwise_dynx(x)
    return w8a8_matmul_plain(xq, xscale, wq, wscale, bias, activation=activation,
                             out_dtype=out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    lib = build.load_library(_KERNEL_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.w8a8_matmul_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.w8a8_matmul_launch.restype = i
    lib.w8a8_quantize_launch.argtypes = [p, i, p, p, i, i, p]
    lib.w8a8_quantize_launch.restype = i
    lib.w8a8_matmul_dynx_launch.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.w8a8_matmul_dynx_launch.restype = i
    lib.w8a8_error_string.argtypes = [i]
    lib.w8a8_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, 16-byte aligned (the kernels' vector and TMA loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _operands(x, wq, wscale, bias, activation, out_dtype):
    """Check what both entries share; returns (wq, wscale, bias, m, n, k)."""
    _check_activation(activation)
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"the W8A8 kernel writes bf16 or f32, got {out_dtype}")
    if x.dim() != 2 or wq.dim() != 2 or wq.dtype != torch.int8:
        raise ValueError(f"the W8A8 kernel takes x (M, K) and int8 wq (N, K), got "
                         f"{tuple(x.shape)} and {wq.dtype} {tuple(wq.shape)}")
    m, k = x.shape
    n = wq.shape[0]
    if wq.shape[1] != k:
        raise ValueError(f"K disagrees: x {tuple(x.shape)}, wq {tuple(wq.shape)}")
    if k % 16 != 0 or k > MAX_K:
        raise ValueError(f"the W8A8 kernel takes K a multiple of 16 up to {MAX_K}, got {k}")
    if wscale.numel() != n or (bias is not None and bias.numel() != n):
        raise ValueError(f"wscale / bias must hold N={n} values")
    for t in (x, wq, wscale) + ((bias,) if bias is not None else ()):
        if t.device != x.device:
            raise ValueError("all operands must lie on one device")
    wscale = wscale.reshape(n).float().contiguous()
    bias = None if bias is None else bias.reshape(n).float().contiguous()
    return _aligned(wq), wscale, bias, m, n, k


def _check(err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"W8A8 kernel launch failed: {lib.w8a8_error_string(err).decode()}")


def w8a8_matmul(xq: torch.Tensor, xscale: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, activation: Optional[str] = None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """(M, N) = act(xq @ wq.T * xscale * wscale + bias) for int8 xq (M, K),
    xscale (M, 1) f32: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if xq.device.type == "cpu":
        return w8a8_matmul_plain(xq, xscale, wq, wscale, bias, activation=activation,
                                 out_dtype=out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"w8a8_matmul runs on cpu or cuda tensors, got {xq.device}")
    if xq.dtype != torch.int8:
        raise ValueError(f"w8a8_matmul takes int8 activations, got {xq.dtype}")
    wq, wscale, bias, m, n, k = _operands(xq, wq, wscale, bias, activation, out_dtype)
    if xscale.numel() != m or xscale.device != xq.device:
        raise ValueError(f"xscale must hold M={m} values on {xq.device}")
    xq = _aligned(xq)
    xscale = xscale.reshape(m).float().contiguous()
    out = torch.empty(m, n, dtype=out_dtype, device=xq.device)
    if m == 0:
        return out
    lib = _kernel_library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.w8a8_matmul_launch(
            xq.data_ptr(), xscale.data_ptr(), wq.data_ptr(), wscale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
            _ACT_CODE[activation], _OUT_CODE[out_dtype], stream)
    _check(err, lib)
    profiling.count("k4.launches")
    return out


def _check_dynx_x(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _X_CODE:
        raise ValueError(f"{name} takes bf16 or f32 activations, got {x.dtype}")


def w8a8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4-dynx's quantize alone: (xq (M, K) int8, xscale (M, 1) f32) of
    bf16 / f32 x (M, K), each row over its full K with
    ``quantize_rowwise_dynx``'s arithmetic: the kernel for CUDA tensors,
    ``quantize_rowwise_dynx`` for CPU tensors."""
    if x.device.type == "cpu":
        return quantize_rowwise_dynx(x)
    _check_dynx_x(x, "w8a8_quantize")
    if x.dim() != 2 or x.shape[1] % 16 != 0 or x.shape[1] > MAX_K:
        raise ValueError(f"w8a8_quantize takes x (M, K), K a multiple of 16 up to {MAX_K}, "
                         f"got {tuple(x.shape)}")
    x = _aligned(x)
    m, k = x.shape
    xq = torch.empty(m, k, dtype=torch.int8, device=x.device)
    xscale = torch.empty(m, 1, dtype=torch.float32, device=x.device)
    if m == 0:
        return xq, xscale
    lib = _kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.w8a8_quantize_launch(x.data_ptr(), _X_CODE[x.dtype], xq.data_ptr(),
                                       xscale.data_ptr(), m, k, stream)
    _check(err, lib)
    profiling.count("k4.quantize_launches")
    return xq, xscale


def w8a8_matmul_dynx(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *, activation: Optional[str] = None,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """Like ``w8a8_matmul`` for unquantized bf16 / f32 x (M, K), quantized
    per row over the full K: for CUDA tensors the quantize kernel (into int8
    scratch) then the GEMM, two launches on the current stream; the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return w8a8_matmul_dynx_plain(x, wq, wscale, bias, activation=activation,
                                      out_dtype=out_dtype)
    _check_dynx_x(x, "w8a8_matmul_dynx")
    wq, wscale, bias, m, n, k = _operands(x, wq, wscale, bias, activation, out_dtype)
    x = _aligned(x)
    out = torch.empty(m, n, dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    xq = torch.empty(m, k, dtype=torch.int8, device=x.device)  # scratch: each row once
    xscale = torch.empty(m, dtype=torch.float32, device=x.device)
    lib = _kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.w8a8_matmul_dynx_launch(
            x.data_ptr(), _X_CODE[x.dtype], xq.data_ptr(), xscale.data_ptr(), wq.data_ptr(),
            wscale.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
            k, _ACT_CODE[activation], _OUT_CODE[out_dtype], stream)
    _check(err, lib)
    profiling.count("k4_dynx.launches")
    return out


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 of an nn.Linear weight (N, K), from its f32
    values: (wq (N, K) int8, wscale (N,) f32). The reduction runs over K, the
    axis a Flax kernel (K, N) reduces as axis 0."""
    wq, ws = quantize_rowwise(weight.detach().float(), dim=1)
    return wq, ws.reshape(-1)


def w8a8_dense_apply(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], *,
                     activation: Optional[str] = None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Quantized dense over (..., K) activations and an f32 nn.Linear weight
    (N, K): the weight is quantized here, the activations inside
    ``w8a8_matmul_dynx``; leading dims are flattened into M."""
    lead, k = x.shape[:-1], x.shape[-1]
    wq, ws = quantize_weight(weight)
    y = w8a8_matmul_dynx(x.reshape(-1, k), wq, ws,
                         None if bias is None else bias.detach().float(),
                         activation=activation, out_dtype=out_dtype)
    return y.reshape(*lead, y.shape[-1])
