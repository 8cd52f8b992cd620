"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA device and nvcc:

    python -m pytest tests/test_torch_gpu.py -m gpu

Without a card every test skips (the kernels have no CPU mode); the CPU
parity of the plain versions with aladin_tpu is in tests/test_torch_*.py.
"""

import pytest
import torch

from aladin_torch.ops.kernels import alignment_kernel as ak
from aladin_torch.ops.kernels import attention_kernel as at
from aladin_torch.ops.kernels import layernorm as lk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA and Triton kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _corpus(gen, n_im, n_cap, s_im, s_s, d):
    return (torch.randn(n_im, s_im, d, generator=gen, device="cuda"),
            torch.randn(n_cap, s_s, d, generator=gen, device="cuda"),
            torch.randint(2, s_im + 1, (n_im,), generator=gen, device="cuda"),
            torch.randint(4, s_s + 1, (n_cap,), generator=gen, device="cuda"))


@pytest.mark.parametrize("shape", [(7, 11, 5, 6, 128), (37, 53, 34, 50, 768),
                                   (5, 9, 129, 20, 200)])
def test_mrsw_kernel_matches_plain(cuda, shape):
    """bf16: atol 1e-3 (same bf16 products, f32 sums in another order;
    observed ~4e-6 at D=768). int8: relative 1e-5 (identical integer sums,
    only the descale rounds). One launch per call."""
    args = _corpus(cuda, *shape)
    for dt in (torch.bfloat16, torch.int8):
        before = ak.mrsw_scores.launches
        got = ak.mrsw_scores(*args, compute_dtype=dt)
        assert ak.mrsw_scores.launches == before + 1
        want = ak.mrsw_scores_plain(*args, compute_dtype=dt)
        assert torch.isfinite(got).all()
        if dt == torch.bfloat16:
            torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
        else:
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_mrsw_kernel_score_is_shape_independent(cuda):
    args = _corpus(cuda, 40, 70, 34, 50, 768)
    full = ak.mrsw_scores(*args)
    part = ak.mrsw_scores(args[0][3:17], args[1][5:61], args[2][3:17], args[3][5:61])
    assert torch.equal(part, full[3:17, 5:61])


def test_mrsw_kernel_refuses_f32(cuda):
    with pytest.raises(ValueError, match="score_all_pairs"):
        ak.mrsw_scores(*_corpus(cuda, 2, 3, 5, 6, 128), compute_dtype=torch.float32)


def _attention_inputs(gen, b, s, q_dim, dtype, h=12, d=64):
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
                  for _ in range(4))
    keep = torch.rand(b, q_dim, s, generator=gen, device="cuda") > 0.2
    keep[0] = False  # a fully padded row stays finite
    return q, k, v, (~keep).float() * -10000.0, g


def _ulp_close(got, want, dtype):
    """bf16: within one bf16 ulp of the largest output (the same f32 math
    with sums in another order, then one rounding to bf16). f32: 1e-5 of
    the largest output (no rounding, only the order of the sums)."""
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,q_dim,rate", [(50, 1, 0.0), (84, 84, 0.1), (134, 1, 0.1),
                                          (7, 7, 0.0)])
def test_attention_kernels_match_plain(cuda, dtype, s, q_dim, rate):
    """K2 forward and backward against their plain versions, dropout on and
    off (the keep mask is the same hash in both); one launch each."""
    q, k, v, bias, g = _attention_inputs(cuda, 16, s, q_dim, dtype)
    args = (q, k, v, bias)
    before = (at.attention_forward.launches, at.attention_backward.launches)
    _ulp_close(at.attention_forward(*args, 5, rate, True),
               at.attention_forward_plain(*args, 5, rate, True), dtype)
    for got, want in zip(at.attention_backward(*args, g, 5, rate, True),
                         at.attention_backward_plain(*args, g, 5, rate, True)):
        _ulp_close(got, want, dtype)
    assert (at.attention_forward.launches, at.attention_backward.launches) == (
        before[0] + 1, before[1] + 1)


def test_attention_autograd_uses_the_kernels(cuda):
    q, k, v, bias, g = _attention_inputs(cuda, 4, 84, 1, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = at.fused_attention(*leaves, bias, 9, 0.1, True)
    _ulp_close(out, at.attention_forward_plain(q, k, v, bias, 9, 0.1, True), torch.bfloat16)
    out.backward(g)
    for leaf, want in zip(leaves, at.attention_backward_plain(q, k, v, bias, g, 9, 0.1, True)):
        _ulp_close(leaf.grad, want, torch.bfloat16)


def test_attention_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v, bias, _ = _attention_inputs(cuda, 2, 8, 1, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        at.attention_forward(q[..., :32], k[..., :32], v[..., :32], bias)
    big = torch.zeros(1, at.MAX_SEQ + 1, 12, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="S <="):
        at.attention_forward(big, big, big, torch.zeros(1, 1, at.MAX_SEQ + 1, device="cuda"))
    with pytest.raises(ValueError, match="bf16 or f32"):
        at.attention_forward(q.half(), k.half(), v.half(), bias)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(128 * 84, 768), (7, 768), (33, 100)])
def test_residual_layernorm_kernel_matches_plain(cuda, x_dtype, m, d):
    """K3a against its plain version: y within one bf16 ulp of the largest
    (f32 for f32 x: 1e-5 of it), the f32 statistics within 1e-4 relative
    (sums in another order); the autograd Function's analytic backward
    against autograd through the plain version, f32 sums 1e-4 relative."""
    x = torch.randn(m, d, generator=cuda, device="cuda").to(x_dtype)
    res = (0.5 * torch.randn(m, d, generator=cuda, device="cuda")).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(d, generator=cuda, device="cuda")
    beta = 0.1 * torch.randn(d, generator=cuda, device="cuda")
    gy = torch.randn(m, d, generator=cuda, device="cuda").to(x_dtype)
    before = lk.residual_layernorm_forward.launches
    y, mean, rstd = lk.residual_layernorm_forward(x, res, gamma, beta)
    assert lk.residual_layernorm_forward.launches == before + 1
    wy, wmean, wrstd = lk.residual_layernorm_forward_plain(x, res, gamma, beta)
    _ulp_close(y, wy, x_dtype)
    torch.testing.assert_close(mean, wmean, rtol=1e-4, atol=1e-4 * wmean.abs().max().item())
    torch.testing.assert_close(rstd, wrstd, rtol=1e-4, atol=0)

    grads = []
    for fn in (lk.residual_layernorm, lk.residual_layernorm_plain):
        leaves = [t.clone().requires_grad_() for t in (x, res, gamma, beta)]
        fn(*leaves).backward(gy)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        if want.dtype == torch.float32 and want.ndim == 1:
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()
        else:
            _ulp_close(got, want, want.dtype)
