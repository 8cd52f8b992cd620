"""Fused residual-add + LayerNorm: the Triton forward kernel, its plain
version, and the autograd Function with the analytic backward (mirrors
aladin_tpu/ops/pallas/layernorm.py::residual_layernorm).

Replaces ``_fwd_kernel`` of aladin_tpu/ops/pallas/layernorm.py (reached
through ``residual_layernorm``): for rows of h = x + res (in f32)

    mean = E[h],  var = max(E[h^2] - E[h]^2, 0),  rstd = rsqrt(var + eps)
    y    = (h - mean) * rstd * gamma + beta        (stored in x's dtype)

with mean and rstd saved as f32 (M, 1) for the backward. The statistics are
the fast-variance form, clamped at 0, not Welford, as in JAX.

Bound on an H100 SXM: one row reduction and one elementwise pass with no
tensor-core work, so it is bytes-bound: x and res read once, y written once,
plus 8 bytes of statistics a row, over 3.35 TB/s. The kernel reads each row
block once into registers, reduces, normalises and writes, so no
intermediate reaches device memory: one program per block of 4 rows, with
the row padded to a power of two (1024 for D = 768) and masked.

  * CUDA tensors launch the Triton kernel (``triton`` is imported inside the
    launching function, never at import);
  * CPU tensors run the plain version, ``residual_layernorm_forward_plain``.

The backward is ``_rln_bwd``'s analytic formula (XLA in the JAX package),
here in torch ops on either device:

    xhat = (h - mean) * rstd, gg = g * gamma
    dh = rstd * (gg - mean(gg) - xhat * mean(gg * xhat))
    dx = dh in x's dtype, dres = dh in res's dtype,
    dgamma = sum_rows g * xhat, dbeta = sum_rows g   (f32)
"""

from __future__ import annotations

import functools

import torch

_BLOCK_M = 4  # rows per program
_MAX_D = 8192


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


def _launch(x2, r2, gamma, beta, eps):
    m, d = x2.shape
    if d > _MAX_D:
        raise ValueError(f"the residual LayerNorm kernel takes D <= {_MAX_D}, got {d}")
    if x2.dtype not in (torch.bfloat16, torch.float16, torch.float32) or r2.dtype not in (
            torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"the residual LayerNorm kernel takes float x/res, got {x2.dtype}/{r2.dtype}")
    y = torch.empty_like(x2)
    mean = torch.empty(m, 1, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(m, 1, dtype=torch.float32, device=x2.device)
    if m == 0:
        return y, mean, rstd
    triton, kernel = _triton_kernel()
    block_d = triton.next_power_of_2(d)
    with torch.cuda.device(x2.device):
        kernel[(triton.cdiv(m, _BLOCK_M),)](
            x2, r2, gamma, beta, y, mean, rstd, m, d, float(eps),
            BLOCK_M=_BLOCK_M, BLOCK_D=block_d, num_warps=4)
    residual_layernorm_forward.launches += 1
    return y, mean, rstd


def residual_layernorm_forward(x, res, gamma, beta, eps: float = 1e-12):
    """(y, mean, rstd): the Triton kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return residual_layernorm_forward_plain(x, res, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"residual_layernorm runs on cpu or cuda tensors, got {x.device}")
    if res.shape != x.shape or gamma.shape != x.shape[-1:] or beta.shape != x.shape[-1:]:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, res {tuple(res.shape)}, "
                         f"gamma {tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    d = x.shape[-1]
    y, mean, rstd = _launch(x.reshape(-1, d).contiguous(), res.reshape(-1, d).contiguous(),
                            gamma.float().contiguous(), beta.float().contiguous(), eps)
    return y.reshape(x.shape), mean, rstd


residual_layernorm_forward.launches = 0  # kernel launches; the plain version does not count


def residual_layernorm_backward(x, res, gamma, mean, rstd, gy):
    """The analytic VJP (aladin_tpu/ops/pallas/layernorm.py::_rln_bwd):
    (dx in x's dtype, dres in res's dtype, dgamma f32, dbeta f32)."""
    d = x.shape[-1]
    h = x.reshape(-1, d).float() + res.reshape(-1, d).float()
    xhat = (h - mean) * rstd
    g = gy.reshape(-1, d).float()
    gg = g * gamma.float()
    m1 = gg.mean(dim=1, keepdim=True)
    m2 = (gg * xhat).mean(dim=1, keepdim=True)
    dh = (rstd * (gg - m1 - xhat * m2)).reshape(x.shape)
    return dh.to(x.dtype), dh.to(res.dtype), (g * xhat).sum(dim=0), g.sum(dim=0)


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
    the forward is the kernel (or its plain version on the CPU), the backward
    the analytic formula."""
    with torch.autocast(x.device.type, enabled=False):
        return _ResidualLayerNorm.apply(x, res, gamma, beta, float(eps))


def residual_layernorm_plain(x: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The same function as plain differentiable PyTorch: autograd derives
    its backward, which the analytic one is held to."""
    return residual_layernorm_forward_plain(x, res, gamma, beta, eps)[0]
