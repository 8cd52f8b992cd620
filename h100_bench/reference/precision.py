"""The precision the plain references multiply in.

``Precision("f32")`` is true float32 (TF32 off), the references' own.
The others are the controls of the output checks, each the nearest step
below what a configuration states:

  * ``"tf32"``: float32 products on the tensor cores' TF32 path (below a
    configuration that states float32 with TF32 off);
  * ``"fp8"`` (below bf16): wherever a bf16 program rounds (each
    product's operands and result, and the activations a caller passes to
    ``act``), the value is rounded to float8 e4m3 and, in the backward,
    its gradient to float8 e5m2, each with one scale a tensor (amax over
    the format's largest value), as float8 training rounds; products
    accumulate in float32.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("f32", "tf32", "fp8")
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def scaled_round(x: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under one scale that maps its
    largest magnitude to the format's ``largest``, back in float32."""
    scale = largest / x.abs().amax().clamp(min=1e-12)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """Forward: round to e4m3; backward: round the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return scaled_round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return scaled_round(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
        self.mode = mode

    @contextlib.contextmanager
    def context(self):
        """TF32 on for "tf32", off otherwise, restored on exit."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        tf32 = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as a program in this precision stores it."""
        return _Fp8.apply(x.float()) if self.mode == "fp8" else x.float()

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.act(torch.matmul(self.act(a), self.act(b)))

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        y = torch.matmul(self.act(x), self.act(w).t())
        return self.act(y if b is None else y + b)
