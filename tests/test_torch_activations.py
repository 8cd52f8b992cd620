"""gelu_exact in aladin_torch (ops/activations.py) against aladin_tpu's
(tests/test_activations.py's four checks, on the same numpy inputs).

Tolerances:
  * forward: bit for bit equal to the port's plain exact GELU
    (``F.gelu(x, approximate="none")``, the op the backbone runs), and to
    ``jax.nn.gelu(approximate=False)`` within 2e-6 relative plus 1e-6
    absolute in f32 (two erf implementations: values near 0 from large
    negative x differ by up to 1e-6 absolute) and 0.02 absolute in bf16
    (JAX computes the bf16 GELU in bf16 arithmetic, the port rounds its f32
    value once, bit for bit);
  * gradients against JAX autodiff of ``jax.nn.gelu`` (and aladin_tpu's
    gelu_exact): rtol 1e-5, atol 1e-6 in f32, the reference's own bounds;
    0.02 absolute in bf16; second order rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from aladin_torch.ops.activations import gelu_exact
from aladin_tpu.ops.activations import gelu_exact as jax_gelu_exact


def _grad(fn, x: torch.Tensor) -> torch.Tensor:
    x = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(fn(x).float().sum(), x)
    return g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_bit_identical(dtype, rng):
    xn = (rng.randn(64, 128) * 3).astype(np.float32)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(xn).to(tdt)
    ours = gelu_exact(x)
    assert ours.dtype == tdt
    assert torch.equal(ours, F.gelu(x, approximate="none"))
    ref = np.asarray(jax.nn.gelu(jnp.asarray(xn, getattr(jnp, dtype)), approximate=False),
                     np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-6, atol=1e-6)
    else:  # the port rounds the f32 value once; JAX's bf16 gelu computes in bf16
        assert torch.equal(ours, F.gelu(x.float(), approximate="none").to(tdt))
        np.testing.assert_allclose(ours.float().numpy(), ref, atol=0.02)


def test_gradient_matches_autodiff(rng):
    xn = (rng.randn(512) * 4).astype(np.float32)
    g_ours = _grad(gelu_exact, torch.from_numpy(xn)).numpy()
    g_ref = np.asarray(jax.grad(lambda v: jax.nn.gelu(v, approximate=False).sum())(
        jnp.asarray(xn)))
    g_jax_custom = np.asarray(jax.grad(lambda v: jax_gelu_exact(v).sum())(jnp.asarray(xn)))
    np.testing.assert_allclose(g_ours, g_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_ours, g_jax_custom, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        g_ours, _grad(lambda v: F.gelu(v, approximate="none"), torch.from_numpy(xn)).numpy(),
        rtol=1e-5, atol=1e-6)
    # extremes: saturated tails stay finite and correct (0 and 1 slopes)
    gt = _grad(gelu_exact, torch.tensor([-20.0, -8.0, 0.0, 8.0, 20.0]))
    np.testing.assert_allclose(gt.numpy(), [0.0, 0.0, 0.5, 1.0, 1.0], atol=1e-6)


def test_gradient_bf16(rng):
    xn = (rng.randn(256) * 3).astype(np.float32)
    g_ours = _grad(gelu_exact, torch.from_numpy(xn).to(torch.bfloat16))
    g_ref = jax.grad(
        lambda v: jax.nn.gelu(v, approximate=False).astype(jnp.float32).sum())(
        jnp.asarray(xn, jnp.bfloat16))
    assert g_ours.dtype == torch.bfloat16
    np.testing.assert_allclose(g_ours.float().numpy(), np.asarray(g_ref, np.float32), atol=0.02)


def test_second_order_via_grad_of_grad(rng):
    """The backward is made of differentiable ops and the saved residual is
    an input of the Function: a gradient of the gradient is exact."""
    xn = rng.randn(32).astype(np.float32)
    x = torch.from_numpy(xn).requires_grad_(True)
    (g,) = torch.autograd.grad(gelu_exact(x).sum(), x, create_graph=True)
    (got,) = torch.autograd.grad(g.sum(), x)
    ref = jax.grad(lambda v: jax.grad(
        lambda u: jax.nn.gelu(u, approximate=False).sum())(v).sum())(jnp.asarray(xn))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
