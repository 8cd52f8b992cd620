"""Exact-erf GELU with an analytic backward, kept as a library utility
(mirrors aladin_tpu/ops/activations.py).

aladin_tpu wrote this as a custom VJP to test whether an analytic backward
(save the forward's erfc term, backward = cdf(x) + x * pdf(x), one exp)
would close the erf-vs-tanh train-step gap; its own A/B on its accelerator
found it neutral, because the gap lives in the forward polynomial, which no
backward can touch. The backbone therefore keeps the plain exact GELU
(``models/bert_img.py::ffn_act``) and nothing on the path calls this: it is
a safe drop-in wherever an explicit-residual GELU is wanted (a remat policy
that keeps the erfc term and does not recompute it, for instance). Its
forward is ``F.gelu(x, approximate="none")`` and its gradients are held to
autograd's (tests/test_torch_activations.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_SQRT_HALF = math.sqrt(0.5)


class _GeluExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, erfc_term):
        ctx.save_for_backward(x, erfc_term)
        return F.gelu(x, approximate="none")

    @staticmethod
    def backward(ctx, g):
        x, erfc_term = ctx.saved_tensors
        pdf = _INV_SQRT_2PI * torch.exp(-0.5 * x * x)
        return g * (0.5 * erfc_term + x * pdf), None


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """``F.gelu(x, approximate="none")`` with the analytic backward
    ``g * (cdf(x) + x * pdf(x))``, cdf from the residual erfc(-x / sqrt 2)
    = 2 cdf(x) kept from the forward in x's dtype. The residual enters as
    an input of the Function, so gradients of gradients see its own
    derivative and are exact too."""
    return _GeluExact.apply(x, torch.special.erfc(-x * _SQRT_HALF))
