"""W8A8 quantized dense layers for the serving encoder (mirrors
aladin_tpu/models/quant.py).

  * weights: symmetric per-output-channel absmax int8, quantized from the
    f32 parameters;
  * activations: symmetric per-row absmax int8, quantized inside the GEMM
    kernel (``w8a8_apply``, K4-dynx) or upstream by the fused LayerNorm
    (``w8a8_apply_xq``, K4 fed by K3b);
  * the product accumulates exactly in int32, and is dequantized by the
    row and column scales, plus bias, optional gelu, in f32.

``QuantLinear`` is an ``nn.Linear`` (same ``weight`` / ``bias`` names and
shapes, so released checkpoints and ``state_dict_from_flax`` load
unchanged) whose parameters stay f32 whatever dtype the model is cast to:
aladin_tpu quantizes the f32 Flax parameters, and quantizing after a bf16
cast would give other int8 weights and scales. The int8 weights and their
scales are cached outside the state dict and made again whenever a
parameter changes (a checkpoint load, a move to another device).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from aladin_torch.ops.kernels.quant_matmul import (ACTIVATIONS, quantize_rowwise,  # noqa: F401
                                                   quantize_weight, w8a8_matmul, w8a8_matmul_dynx)
# Functional W8A8 dense over (..., K) activations and an nn.Linear weight
# (N, K): K4-dynx on the card, its plain version on the CPU.
from aladin_torch.ops.kernels.quant_matmul import w8a8_dense_apply as w8a8_apply  # noqa: F401


def w8a8_apply_xq(xq: torch.Tensor, xscale: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], *, activation: Optional[str] = None,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """W8A8 dense over activations quantized upstream, xq (..., K) int8 and
    xscale (..., 1) f32: K4 (``w8a8_matmul``) on the card, its plain version
    on the CPU."""
    wq, ws = quantize_weight(weight)
    b = None if bias is None else bias.detach().float()
    return _matmul_xq(xq, xscale, (wq, ws, b), activation, out_dtype)


def _matmul_xq(xq, xscale, weights, activation, out_dtype):
    lead, k = xq.shape[:-1], xq.shape[-1]
    y = w8a8_matmul(xq.reshape(-1, k), xscale.reshape(-1, 1), *weights, activation=activation,
                    out_dtype=out_dtype)
    return y.reshape(*lead, y.shape[-1])


def _matmul_dynx(x, weights, activation, out_dtype):
    lead, k = x.shape[:-1], x.shape[-1]
    y = w8a8_matmul_dynx(x.reshape(-1, k), *weights, activation=activation, out_dtype=out_dtype)
    return y.reshape(*lead, y.shape[-1])


Weights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # wq (N, K) int8, wscale (N,), bias (N,)


class QuantLinear(nn.Linear):
    """nn.Linear-compatible W8A8 projection with an optional fused
    activation; its f32 ``weight`` and ``bias`` follow a move to another
    device but never a cast to another dtype."""

    def __init__(self, in_features: int, out_features: int, activation: Optional[str] = None):
        super().__init__(in_features, out_features)
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r} ({ACTIVATIONS})")
        self.activation = activation
        self._cache = None  # (parameter versions, Weights): a plain attribute, not state

    def _apply(self, fn, recurse: bool = True):
        def keep_dtype(t):
            out = fn(t)
            return out if out.dtype == t.dtype else t.to(out.device)
        return super()._apply(keep_dtype, recurse)

    def quantized(self) -> Weights:
        """(wq, wscale, bias f32) of the current parameters, cached."""
        key = tuple((t.device, t.data_ptr(), t._version) for t in (self.weight, self.bias))
        if self._cache is None or self._cache[0] != key:
            with torch.no_grad():
                wq, ws = quantize_weight(self.weight)
                self._cache = (key, (wq, ws, self.bias.detach().float()))
        return self._cache[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """K4-dynx over bf16 / f32 x; the output takes x's dtype."""
        return _matmul_dynx(x, self.quantized(), self.activation, x.dtype)

    def forward_xq(self, xq: torch.Tensor, xscale: torch.Tensor, out_dtype) -> torch.Tensor:
        """K4 over activations quantized upstream."""
        return _matmul_xq(xq, xscale, self.quantized(), self.activation, out_dtype)


class FusedQuantLinear:
    """Several QuantLinear layers run as one GEMM over their outputs
    concatenated (the fused QKV): per-channel scales make that equal to
    quantizing each part on its own. The concatenation is cached until a
    part's quantized weights change."""

    def __init__(self, parts: Sequence[QuantLinear]):
        self.parts = list(parts)
        self._cache = None  # (the parts' Weights, the concatenation)

    def quantized(self) -> Weights:
        parts = [p.quantized() for p in self.parts]
        if self._cache is None or any(a is not b for a, b in zip(self._cache[0], parts)):
            self._cache = (parts, tuple(torch.cat(t) for t in zip(*parts)))
        return self._cache[1]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _matmul_dynx(x, self.quantized(), None, x.dtype)

    def forward_xq(self, xq: torch.Tensor, xscale: torch.Tensor, out_dtype) -> torch.Tensor:
        return _matmul_xq(xq, xscale, self.quantized(), None, out_dtype)
