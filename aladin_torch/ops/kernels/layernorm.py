"""Fused residual-add + LayerNorm: the forward kernel (Triton), its backward
and the q8 serving variant (CUDA, ``csrc/layernorm_kernel.cu``), their plain
versions, and the autograd Function (mirrors
aladin_tpu/ops/pallas/layernorm.py::residual_layernorm).

K3a's forward replaces ``_fwd_kernel`` (reached through
``residual_layernorm``): for rows of h = x + res (in f32)

    mean = E[h],  var = max(E[h^2] - E[h]^2, 0),  rstd = rsqrt(var + eps)
    y    = (h - mean) * rstd * gamma + beta        (stored in x's dtype)

with mean and rstd saved as f32 (M, 1) for the backward. The statistics are
the fast-variance form, clamped at 0, not Welford, as in JAX. Bound on an
H100 SXM: one row reduction and one elementwise pass with no tensor-core
work, so it is bytes-bound: x and res read once, y written once, plus 8
bytes of statistics a row, over 3.35 TB/s. The Triton kernel reads each row
block once into registers, reduces, normalises and writes: one program per
block of 4 rows, with the row padded to a power of two (1024 for D = 768)
and masked.

The backward is ``_rln_bwd``'s analytic VJP (XLA in the JAX package):

    xhat = (h - mean) * rstd, gg = g * gamma
    dh = rstd * (gg - mean(gg) - xhat * mean(gg * xhat))
    dx = dh in x's dtype, dres = dh in res's dtype,
    dgamma = sum_rows g * xhat, dbeta = sum_rows g   (f32)

on the card one warp a row with dgamma / dbeta summed in a fixed order (two
calls give the same bits); when x and res share a dtype dx and dres are one
tensor, returned twice.

K3b replaces ``_fwd_kernel_q8`` (reached through ``residual_layernorm_q8``)
for the int8 serving encoder: the same y, and instead of the statistics the
per-row int8 of the f32 y as ``quantize_rowwise`` computes it (scale =
max(absmax, 1e-8) / 127 and q = rint(y / scale) clipped to +-127, both
divisions IEEE), so (y, q, s) = (M, D) in x's dtype, (M, D) int8, (M, 1)
f32. ``layernorm_q8`` (the layer-0 seed) is plain torch, as it is plain XLA
in aladin_tpu. The source note of ``csrc/layernorm_kernel.cu`` has the
CUDA kernels' design and bound.

  * CUDA tensors launch the kernels (``triton`` is imported, and the CUDA
    source built, inside the launching function, never at import); inputs
    they cannot take raise, and a failed build or launch raises;
  * CPU tensors run the plain versions.

Each entry counts its calls that launched a kernel in ``utils/profiling.py``
(``k3a.fwd_launches``, ``k3a.bwd_launches``, ``k3b.launches``): one for the
backward, though it is two kernel launches (the row pass and the sum of the
dgamma / dbeta partial rows).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aladin_torch.ops.kernels import build
from aladin_torch.ops.kernels.quant_matmul import quantize_rowwise
from aladin_torch.utils import profiling

_KERNEL_SOURCE = "layernorm_kernel.cu"
_BLOCK_M = 4  # rows per program of the Triton forward
_MAX_D = 8192
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def _stats_plain(h: torch.Tensor, eps: float):
    mean = h.mean(dim=1, keepdim=True)
    var = torch.clamp((h * h).mean(dim=1, keepdim=True) - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def residual_layernorm_forward_plain(x, res, gamma, beta, eps: float = 1e-12):
    """The kernel's arithmetic in PyTorch: (y in x's dtype, mean, rstd) with
    the statistics (M, 1) f32 over the rows of x.reshape(-1, D)."""
    d = x.shape[-1]
    h = x.reshape(-1, d).float() + res.reshape(-1, d).float()
    mean, rstd = _stats_plain(h, eps)
    y = (h - mean) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype).reshape(x.shape), mean, rstd


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rln_fwd(x_ptr, r_ptr, g_ptr, b_ptr, y_ptr, mean_ptr, rstd_ptr, m, d, eps,
                BLOCK_M: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.arange(0, BLOCK_D)
        rmask = rows < m
        cmask = cols < d
        mask = rmask[:, None] & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * d + cols[None, :]
        h = (tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
             + tl.load(r_ptr + offs, mask=mask, other=0.0).to(tl.float32))
        mean = tl.sum(h, axis=1) / d
        var = tl.maximum(tl.sum(h * h, axis=1) / d - mean * mean, 0.0)
        rstd = tl.rsqrt(var + eps)
        gamma = tl.load(g_ptr + cols, mask=cmask, other=0.0)
        beta = tl.load(b_ptr + cols, mask=cmask, other=0.0)
        y = (h - mean[:, None]) * rstd[:, None] * gamma[None, :] + beta[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)
        tl.store(mean_ptr + rows, mean, mask=rmask)
        tl.store(rstd_ptr + rows, rstd, mask=rmask)

    return triton, rln_fwd


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    lib = build.load_library(_KERNEL_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rln_q8_launch.argtypes = [p, i, p, i, p, p, p, p, p, i, i, ctypes.c_float, p]
    lib.rln_q8_launch.restype = i
    lib.rln_bwd_partial_rows.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.rln_bwd_partial_rows.restype = i
    lib.rln_bwd_launch.argtypes = [p, i, p, i, p, i, p, p, p, p, p, p, p, i, i, i, p]
    lib.rln_bwd_launch.restype = i
    lib.rln_quotient_launch.argtypes = [p, p, p, ctypes.c_long, p]
    lib.rln_quotient_launch.restype = i
    lib.rln_error_string.argtypes = [i]
    lib.rln_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"LayerNorm kernel launch failed: {lib.rln_error_string(err).decode()}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _rows(x, res, name: str):
    """Check the (..., D) float operands of a launch on the card; returns
    (x, res) as contiguous (M, D)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {x.device}")
    if res.shape != x.shape or res.device != x.device:
        raise ValueError(f"{name}: x {tuple(x.shape)} and res {tuple(res.shape)} disagree")
    d = x.shape[-1]
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"{name} takes 1 <= D <= {_MAX_D}, got {d}")
    if x.dtype not in _DTYPE_CODE or res.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes bf16, f16 or f32 x/res, got {x.dtype}/{res.dtype}")
    return x.reshape(-1, d).contiguous(), res.reshape(-1, d).contiguous()


def _vector(v: torch.Tensor, d: int, name: str, device) -> torch.Tensor:
    if v.shape != (d,) or v.device != device:
        raise ValueError(f"{name} must be ({d},) on {device}, got {tuple(v.shape)} on {v.device}")
    return v.float().contiguous()


def residual_layernorm_forward(x, res, gamma, beta, eps: float = 1e-12):
    """(y, mean, rstd): the Triton kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return residual_layernorm_forward_plain(x, res, gamma, beta, eps)
    x2, r2 = _rows(x, res, "residual_layernorm")
    d = x2.shape[1]
    gamma, beta = (_vector(v, d, n, x.device) for v, n in ((gamma, "gamma"), (beta, "beta")))
    m = x2.shape[0]
    y = torch.empty_like(x2)
    mean = torch.empty(m, 1, dtype=torch.float32, device=x.device)
    rstd = torch.empty(m, 1, dtype=torch.float32, device=x.device)
    if m > 0:
        triton, kernel = _triton_kernel()
        with torch.cuda.device(x.device):
            kernel[(triton.cdiv(m, _BLOCK_M),)](
                x2, r2, gamma, beta, y, mean, rstd, m, d, float(eps), BLOCK_M=_BLOCK_M,
                BLOCK_D=triton.next_power_of_2(d), num_warps=4)
        profiling.count("k3a.fwd_launches")
    return y.reshape(x.shape), mean, rstd


def residual_layernorm_backward_plain(x, res, gamma, mean, rstd, gy):
    """The analytic VJP (aladin_tpu/ops/pallas/layernorm.py::_rln_bwd) in
    torch ops: (dx in x's dtype, dres in res's dtype, dgamma f32, dbeta f32)."""
    d = x.shape[-1]
    h = x.reshape(-1, d).float() + res.reshape(-1, d).float()
    xhat = (h - mean) * rstd
    g = gy.reshape(-1, d).float()
    gg = g * gamma.float()
    m1 = gg.mean(dim=1, keepdim=True)
    m2 = (gg * xhat).mean(dim=1, keepdim=True)
    dh = (rstd * (gg - m1 - xhat * m2)).reshape(x.shape)
    return dh.to(x.dtype), dh.to(res.dtype), (g * xhat).sum(dim=0), g.sum(dim=0)


@functools.lru_cache(maxsize=None)
def _partial_rows(device_index: int, m: int, d: int, wide: bool) -> int:
    """Rows of dgamma / dbeta partials the backward writes for (m, d);
    ``wide``: an input is f32 (another kernel instantiation, another grid)."""
    lib = _kernel_library()
    rows = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check(lib.rln_bwd_partial_rows(m, d, int(wide), ctypes.byref(rows)), lib)
    return rows.value


def residual_layernorm_backward(x, res, gamma, mean, rstd, gy):
    """(dx in x's dtype, dres in res's dtype, dgamma f32, dbeta f32): the
    CUDA kernel for CUDA tensors (dx and dres one tensor when x and res
    share a dtype), ``residual_layernorm_backward_plain`` for CPU tensors."""
    if x.device.type == "cpu":
        return residual_layernorm_backward_plain(x, res, gamma, mean, rstd, gy)
    x2, r2 = _rows(x, res, "residual_layernorm_backward")
    m, d = x2.shape
    if gy.shape != x.shape or gy.device != x.device or gy.dtype not in _DTYPE_CODE:
        raise ValueError(f"residual_layernorm_backward: gy {gy.dtype} {tuple(gy.shape)} "
                         f"does not match x {tuple(x.shape)}")
    if mean.numel() != m or rstd.numel() != m:
        raise ValueError(f"mean / rstd must hold M={m} values")
    g2 = gy.reshape(-1, d).contiguous()
    gamma = _vector(gamma, d, "gamma", x.device)
    mean, rstd = (t.reshape(m).float().contiguous() for t in (mean, rstd))
    dx = torch.empty_like(x2)
    dres = dx if r2.dtype == x2.dtype else torch.empty_like(r2)
    dgb = torch.empty(2 * d, dtype=torch.float32, device=x.device)
    if m == 0:
        dgb.zero_()
    else:
        lib = _kernel_library()
        wide = torch.float32 in (x2.dtype, r2.dtype, g2.dtype)
        partial = torch.empty(_partial_rows(x.device.index, m, d, wide), 2 * d,
                              dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            err = lib.rln_bwd_launch(
                x2.data_ptr(), _DTYPE_CODE[x2.dtype], r2.data_ptr(), _DTYPE_CODE[r2.dtype],
                g2.data_ptr(), _DTYPE_CODE[g2.dtype], gamma.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), dx.data_ptr(), None if dres is dx else dres.data_ptr(),
                dgb.data_ptr(), partial.data_ptr(), partial.shape[0], m, d, _stream(x.device))
        _check(err, lib)
        profiling.count("k3a.bwd_launches")
    return dx.reshape(x.shape), dres.reshape(res.shape), dgb[:d], dgb[d:]


class _ResidualLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, gamma, beta, eps):
        y, mean, rstd = residual_layernorm_forward(x, res, gamma, beta, eps)
        ctx.save_for_backward(x, res, gamma, mean, rstd)
        ctx.beta_dtype = beta.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x, res, gamma, mean, rstd = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            dx, dres, dgamma, dbeta = residual_layernorm_backward(x, res, gamma, mean, rstd, gy)
        return dx, dres, dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype), None


def residual_layernorm(x: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm(x + res) * gamma + beta over the last axis, y in x's dtype;
    the forward and the analytic backward are the kernels (or their plain
    versions on the CPU)."""
    with torch.autocast(x.device.type, enabled=False):
        return _ResidualLayerNorm.apply(x, res, gamma, beta, float(eps))


def residual_layernorm_plain(x: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The same function as plain differentiable PyTorch: autograd derives
    its backward, which the analytic one is held to."""
    return residual_layernorm_forward_plain(x, res, gamma, beta, eps)[0]


# serving path (no gradient): K3b and the layer-0 seed


def residual_layernorm_q8_plain(x, res, gamma, beta, eps: float = 1e-12):
    """K3b's arithmetic in PyTorch: (y in x's dtype, q int8, s f32) where
    (q, s) is ``quantize_rowwise`` of the f32 y over the last axis; shapes
    (..., D), (..., D), (..., 1)."""
    d = x.shape[-1]
    h = x.reshape(-1, d).float() + res.reshape(-1, d).float()
    mean, rstd = _stats_plain(h, eps)
    y = (h - mean) * rstd * gamma.float() + beta.float()
    q, s = quantize_rowwise(y, dim=-1)
    return y.to(x.dtype).reshape(x.shape), q.reshape(x.shape), s.reshape(*x.shape[:-1], 1)


def residual_layernorm_q8(x: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, eps: float = 1e-12):
    """LayerNorm(x + res) * gamma + beta and the per-row int8 of its f32
    value, (y, q, s) as ``residual_layernorm_q8_plain`` gives them: the
    CUDA kernel (K3b) for CUDA tensors, the plain version for CPU tensors.
    Serving only: no gradient flows through it."""
    with torch.no_grad():
        if x.device.type == "cpu":
            return residual_layernorm_q8_plain(x, res, gamma, beta, eps)
        x2, r2 = _rows(x, res, "residual_layernorm_q8")
        m, d = x2.shape
        gamma, beta = (_vector(v, d, n, x.device) for v, n in ((gamma, "gamma"), (beta, "beta")))
        y = torch.empty_like(x2)
        q = torch.empty(m, d, dtype=torch.int8, device=x.device)
        s = torch.empty(m, 1, dtype=torch.float32, device=x.device)
        if m > 0:
            lib = _kernel_library()
            with torch.cuda.device(x.device):
                err = lib.rln_q8_launch(
                    x2.data_ptr(), _DTYPE_CODE[x2.dtype], r2.data_ptr(), _DTYPE_CODE[r2.dtype],
                    gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), q.data_ptr(), s.data_ptr(),
                    m, d, float(eps), _stream(x.device))
            _check(err, lib)
            profiling.count("k3b.launches")
    return y.reshape(x.shape), q.reshape(x.shape), s.reshape(*x.shape[:-1], 1)


def layernorm_q8(x: torch.Tensor):
    """(q, s): the per-row int8 of an already normalised hidden state, the
    layer-0 seed of the quantized encoder; plain torch on either device, as
    it is plain XLA in aladin_tpu."""
    return quantize_rowwise(x.detach().float(), dim=-1)


def quotient(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """y / s for f32 CUDA tensors of one shape, as K3b and K4-dynx's
    quantize compute it (``quotient`` of ``csrc/rowquant.cuh``: the
    reciprocal product and one fma correction): the card tests hold it to
    the IEEE divide bit for bit."""
    if y.device.type != "cuda" or y.dtype != torch.float32 or s.dtype != torch.float32:
        raise ValueError("quotient takes f32 CUDA tensors")
    if s.shape != y.shape or s.device != y.device:
        raise ValueError(f"y {tuple(y.shape)} and s {tuple(s.shape)} disagree")
    y, s = y.contiguous(), s.contiguous()
    out = torch.empty_like(y)
    lib = _kernel_library()
    with torch.cuda.device(y.device):
        err = lib.rln_quotient_launch(y.data_ptr(), s.data_ptr(), out.data_ptr(), y.numel(),
                                      _stream(y.device))
    _check(err, lib)
    return out
