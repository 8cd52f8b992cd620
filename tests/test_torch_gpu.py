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
from aladin_torch.ops.kernels import quant_matmul as qm

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


# (n_im, n_cap, S_im, S_s, D): small, the benchmark's widths, D off 128 bytes;
# R 1 / W 1; R 8 / W 16; the main path's R 50 / W 13; R 128 / W 128; an image
# count that is no multiple of a group
_MRSW_SHAPES = [(7, 11, 5, 6, 128), (37, 53, 34, 50, 768), (5, 9, 129, 20, 200),
                (9, 13, 2, 4, 768), (17, 29, 9, 19, 768), (8, 33, 51, 16, 768),
                (3, 5, 129, 131, 768), (1001, 70, 34, 50, 768)]


@pytest.mark.parametrize("shape", _MRSW_SHAPES)
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


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.int8])
def test_mrsw_kernel_zero_floor(cuda, dt):
    """Image 0 fills its buffer and word 1 of caption 0 points against all
    its regions and image 1's: image 0's max is negative (no floor), image
    1's is floored at 0 by its zeroed regions. Tolerances as above."""
    im, cap, il, sl = _corpus(cuda, 4, 3, 34, 50, 768)
    il[0], il[1] = 34, 10
    cap[0, 1] = -(im[0, 1:].sum(0) + im[1, 1:10].sum(0))
    got = ak.mrsw_scores(im, cap, il, sl, compute_dtype=dt)
    want = ak.mrsw_scores_plain(im, cap, il, sl, compute_dtype=dt)
    if dt == torch.bfloat16:
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    else:
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_mrsw_kernel_bucketed_equals_unbucketed(cuda):
    """bf16 bucketing drops only zero words, which the kernel sums after the
    real ones: the scores are bitwise equal."""
    im, cap, il, _ = _corpus(cuda, 300, 700, 34, 50, 768)
    sl = torch.randint(4, 51, (700,), generator=cuda, device="cuda")
    full = ak.mrsw_scores(im, cap, il, sl)
    assert torch.equal(ak.mrsw_scores_bucketed(im, cap, il, sl), full)


def test_mrsw_kernel_score_is_shape_independent(cuda):
    args = _corpus(cuda, 40, 70, 34, 50, 768)
    full = ak.mrsw_scores(*args)
    part = ak.mrsw_scores(args[0][3:17], args[1][5:61], args[2][3:17], args[3][5:61])
    assert torch.equal(part, full[3:17, 5:61])


def test_mrsw_kernel_refuses_f32(cuda):
    with pytest.raises(ValueError, match="score_all_pairs"):
        ak.mrsw_scores(*_corpus(cuda, 2, 3, 5, 6, 128), compute_dtype=torch.float32)


def _attention_inputs(gen, b, s, q_dim, dtype, h=12, d=64, qk_scale=1.0):
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device="cuda") for _ in range(4))
    q, k = q * qk_scale, k * qk_scale
    keep = torch.rand(b, q_dim, s, generator=gen, device="cuda") > 0.2
    keep[0] = False  # a fully padded row stays finite
    return (*(t.to(dtype) for t in (q, k, v)), (~keep).float() * -10000.0, g.to(dtype))


def _ulp_close(got, want, dtype):
    """bf16 / f16: within one ulp of the largest output in that type (the
    same f32 math with sums in another order, then one rounding). f32: 1e-5
    of the largest output (no rounding, only the order of the sums)."""
    rel = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(dtype, 1e-5)
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


def _attention_matches_plain(q, k, v, bias, g, rate, dtype, backward=True):
    """K2 forward (and backward) against the plain versions; one launch each."""
    args = (q, k, v, bias)
    before = (at.attention_forward.launches, at.attention_backward.launches)
    _ulp_close(at.attention_forward(*args, 5, rate, True),
               at.attention_forward_plain(*args, 5, rate, True), dtype)
    if backward:
        for got, want in zip(at.attention_backward(*args, g, 5, rate, True),
                             at.attention_backward_plain(*args, g, 5, rate, True)):
            _ulp_close(got, want, dtype)
    assert (at.attention_forward.launches, at.attention_backward.launches) == (
        before[0] + 1, before[1] + int(backward))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_2d", [False, True])
@pytest.mark.parametrize("s", [7, 17, 50, 84, 134, 160])
def test_attention_kernels_match_plain(cuda, dtype, s, bias_2d, rate):
    """K2 forward and backward against their plain versions, dropout on and
    off (the keep mask is the same hash in both), 1-D and 2-D biases, S
    ragged against the bf16 kernels' 16-row tiles up to MAX_SEQ. bf16 runs
    the tensor-core kernels, f32 the CUDA-core ones, whose backward needs
    too much shared memory at S 160: there it must refuse."""
    q, k, v, bias, g = _attention_inputs(cuda, 16, s, s if bias_2d else 1, dtype)
    f32_refuses = dtype == torch.float32 and s > 142
    _attention_matches_plain(q, k, v, bias, g, rate, dtype, backward=not f32_refuses)
    if f32_refuses:
        with pytest.raises(ValueError, match="shared memory"):
            at.attention_backward(q, k, v, bias, g, 5, rate, True)


@pytest.mark.parametrize("bias_2d", [False, True])
@pytest.mark.parametrize("s", [84, 160])
def test_attention_kernels_hold_large_scores(cuda, s, bias_2d):
    """bf16 with q and k scaled by sqrt(8), so the logits q.k / 8 reach
    about +-40: the softmax stays stable and the backward's bf16 pd / ds
    stay within one bf16 ulp of the largest output."""
    q, k, v, bias, g = _attention_inputs(cuda, 16, s, s if bias_2d else 1, torch.bfloat16,
                                         qk_scale=8 ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8
    assert logits.abs().max().item() >= 35
    _attention_matches_plain(q, k, v, bias, g, 0.1, torch.bfloat16)


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


def _ln_backward_inputs(gen, m, d, x_dtype, res_dtype=torch.bfloat16):
    """(x, res, gamma, mean, rstd, gy) with the forward's statistics."""
    x = torch.randn(m, d, generator=gen, device="cuda").to(x_dtype)
    res = (0.5 * torch.randn(m, d, generator=gen, device="cuda")).to(res_dtype)
    gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
    gy = torch.randn(m, d, generator=gen, device="cuda").to(x_dtype)
    _, mean, rstd = lk.residual_layernorm_forward_plain(x, res, gamma, beta)
    return x, res, gamma, mean, rstd, gy


def _ln_backward_matches_plain(args):
    """The backward kernel against its plain version: dx / dres within one
    ulp of the largest in their type (f32: 1e-5 of it; the same f32 terms,
    the two row means summed in another order), dgamma / dbeta f32 within 1e-4 of
    the largest (column sums in another order). One launch; when x and res
    share a dtype dx and dres are one tensor."""
    x, res = args[:2]
    before = lk.residual_layernorm_backward.launches
    got = lk.residual_layernorm_backward(*args)
    assert lk.residual_layernorm_backward.launches == before + 1
    want = lk.residual_layernorm_backward_plain(*args)
    assert got[0].shape == x.shape and got[1].shape == res.shape
    for g, w in zip(got[:2], want[:2]):
        _ulp_close(g, w, w.dtype)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    assert (got[0].data_ptr() == got[1].data_ptr()) == (x.dtype == res.dtype)
    return got


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [768, 100])
@pytest.mark.parametrize("m", [128 * 84, 128 * 50, 7])
def test_residual_layernorm_backward_kernel_matches_plain(cuda, m, d, x_dtype):
    """The train step's M 10752 / 6400 and a few rows, at the model's D and
    at a D that is no multiple of 8 (rows not 16-byte aligned); bf16 x
    shares its output with res, f32 x has a second one."""
    _ln_backward_matches_plain(_ln_backward_inputs(cuda, m, d, x_dtype))


@pytest.mark.parametrize("x_dtype,res_dtype", [(torch.bfloat16, torch.bfloat16),
                                               (torch.float32, torch.bfloat16),
                                               (torch.float16, torch.float32)])
@pytest.mark.parametrize("m,d", [(37, 1100), (300, 4100), (9, 8192)])
def test_residual_layernorm_backward_kernel_past_the_registers(cuda, m, d, x_dtype, res_dtype):
    """D above the register layout's 1024: the rows walked twice and
    dgamma / dbeta from the column kernel, in any mix of types."""
    _ln_backward_matches_plain(_ln_backward_inputs(cuda, m, d, x_dtype, res_dtype))


@pytest.mark.parametrize("m,d", [(128 * 84, 768), (300, 4100)])
def test_residual_layernorm_backward_is_bitwise_repeatable(cuda, m, d):
    """dgamma / dbeta are summed in a fixed order (no atomics): two calls on
    the same inputs give the same bits, and so do dx / dres."""
    args = _ln_backward_inputs(cuda, m, d, torch.bfloat16)
    first = [t.clone() for t in lk.residual_layernorm_backward(*args)]
    for a, b in zip(first, lk.residual_layernorm_backward(*args)):
        assert torch.equal(a, b)


def test_residual_layernorm_autograd_uses_the_backward_kernel(cuda):
    """Through the autograd Function at the model's shapes (bf16 x and res,
    f32 gamma / beta): one forward and one backward launch, gradients as
    the plain version's within the tolerances above."""
    x, res, gamma, _, _, gy = _ln_backward_inputs(cuda, 2 * 84, 768, torch.bfloat16)
    beta = torch.zeros_like(gamma)
    leaves = [t.clone().requires_grad_() for t in (x, res, gamma, beta)]
    before = (lk.residual_layernorm_forward.launches, lk.residual_layernorm_backward.launches)
    lk.residual_layernorm(*leaves).backward(gy)
    assert (lk.residual_layernorm_forward.launches,
            lk.residual_layernorm_backward.launches) == (before[0] + 1, before[1] + 1)
    _, mean, rstd = lk.residual_layernorm_forward_plain(x, res, gamma, beta)
    want = lk.residual_layernorm_backward_plain(x, res, gamma, mean, rstd, gy)
    _ulp_close(leaves[0].grad, want[0], torch.bfloat16)
    _ulp_close(leaves[1].grad, want[1], torch.bfloat16)
    for leaf, w in zip(leaves[2:], want[2:]):
        assert (leaf.grad - w).abs().max() <= 1e-4 * w.abs().max()


def test_residual_layernorm_kernels_refuse_what_they_cannot_take(cuda):
    x = torch.zeros(4, lk._MAX_D + 8, device="cuda", dtype=torch.bfloat16)
    g = torch.ones(lk._MAX_D + 8, device="cuda")
    stats = torch.ones(4, 1, device="cuda")
    with pytest.raises(ValueError, match="D <="):
        lk.residual_layernorm_backward(x, x, g, stats, stats, x)
    with pytest.raises(ValueError, match="D <="):
        lk.residual_layernorm_q8(x, x, g, g)
    y = torch.zeros(4, 16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16, f16 or f32"):
        lk.residual_layernorm_q8(y.to(torch.int32), y, g[:16], g[:16])
    with pytest.raises(ValueError, match="gy"):
        lk.residual_layernorm_backward(y, y, g[:16], stats, stats, y[:, :8])


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_rowquant_quotient_is_the_ieee_divide(cuda):
    """rowquant.cuh's quotient (K3b's and K4-dynx's q before rint) is the
    IEEE divide bit for bit: on 10^7 random y with |y / s| <= 127 over
    scales 2^-34..2^60 (K3b's smallest scale is 1e-8 / 127 ~ 2^-34), on
    each (k + 1/2) * s and its two f32 neighbours for k in -127..126 (the
    rint boundaries) over 200 scales, and on +-0."""
    n = 10 ** 7
    s = (1 + torch.rand(n, generator=cuda, device="cuda")) * torch.exp2(
        torch.randint(-34, 61, (n,), generator=cuda, device="cuda").float())
    y = (2 * torch.rand(n, generator=cuda, device="cuda") - 1) * 127 * s
    assert torch.equal(_bits(lk.quotient(y, s)), _bits(y / s))

    scales = (1 + torch.rand(200, generator=cuda, device="cuda")) * torch.exp2(
        torch.linspace(-34, 60, 200, device="cuda").round())
    k = torch.arange(-127, 127, device="cuda").float() + 0.5
    mid = (k[None, :] * scales[:, None]).reshape(-1)
    inf = torch.full_like(mid, float("inf"))
    y = torch.cat([mid, torch.nextafter(mid, inf), torch.nextafter(mid, -inf)])
    s = scales[:, None].expand(-1, k.numel()).reshape(-1).repeat(3)
    assert torch.equal(_bits(lk.quotient(y, s)), _bits(y / s))

    zeros = torch.tensor([0.0, -0.0, 0.0, -0.0], device="cuda")
    s = torch.tensor([1e-10, 1e-10, 3.0, 7e20], device="cuda")
    assert torch.equal(_bits(lk.quotient(zeros, s)), _bits(zeros / s))


def _w8a8_inputs(gen, m, k, n):
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = 0.03 * torch.randn(n, k, generator=gen, device="cuda")
    b = 0.1 * torch.randn(n, generator=gen, device="cuda")
    return x, *qm.quantize_weight(w), b


@pytest.mark.parametrize("activation", [None, "gelu", "gelu_tanh"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [7, 2688])
def test_w8a8_kernels_match_plain(cuda, activation, out_dtype, m):
    """K4 and K4-dynx against their plain versions at K 768, N 2304: the
    int32 sums are exact and the f32 epilogue is the same arithmetic, so
    f32 results agree to 1e-6 of the largest without an activation (1e-5
    with one: erff / tanhf against torch's) and bf16 results to one bf16
    ulp of the largest. One launch each."""
    x, wq, ws, b = _w8a8_inputs(cuda, m, 768, 2304)
    xq, xs = qm.quantize_rowwise(x)
    before = (qm.w8a8_matmul.launches, qm.w8a8_matmul_dynx.launches)
    kw = {"activation": activation, "out_dtype": out_dtype}
    pairs = ((qm.w8a8_matmul(xq, xs, wq, ws, b, **kw),
              qm.w8a8_matmul_plain(xq, xs, wq, ws, b, **kw)),
             (qm.w8a8_matmul_dynx(x, wq, ws, b, **kw),
              qm.w8a8_matmul_dynx_plain(x, wq, ws, b, **kw)))
    assert (qm.w8a8_matmul.launches, qm.w8a8_matmul_dynx.launches) == (before[0] + 1, before[1] + 1)
    for got, want in pairs:
        assert got.shape == (m, 2304) and got.dtype == out_dtype and torch.isfinite(got).all()
        rel = 2.0 ** -7 if out_dtype == torch.bfloat16 else (1e-6 if activation is None else 1e-5)
        assert (got.float() - want.float()).abs().max() <= rel * want.float().abs().max()


def test_w8a8_dynx_quantizes_like_its_plain_version(cuda):
    """The in-kernel q and scale equal quantize_rowwise_dynx's bitwise: the
    f32 output without activation equals the plain GEMM on them exactly."""
    x, wq, ws, b = _w8a8_inputs(cuda, 300, 768, 3072)
    xq, xs = qm.quantize_rowwise_dynx(x)
    assert torch.equal(qm.w8a8_matmul_dynx(x, wq, ws, b, out_dtype=torch.float32),
                       qm.w8a8_matmul_plain(xq, xs, wq, ws, b, out_dtype=torch.float32))


def _w8a8_f32_both(x, wq, ws, b):
    """K4 on the quantize kernel's xq / xscale and K4-dynx, f32 out, no
    activation, with the plain GEMM on the same xq / xscale: the int32 sums
    are exact and the f32 epilogue is the same arithmetic, so all three are
    equal bit for bit."""
    xq, xs = qm.w8a8_quantize(x)
    want = qm.w8a8_matmul_plain(xq, xs, wq, ws, b, out_dtype=torch.float32)
    got = qm.w8a8_matmul(xq, xs, wq, ws, b, out_dtype=torch.float32)
    dynx = qm.w8a8_matmul_dynx(x, wq, ws, b, out_dtype=torch.float32)
    assert got.shape == dynx.shape == (x.shape[0], wq.shape[0])
    assert torch.equal(got, want)
    assert torch.equal(dynx, got)
    return got


@pytest.mark.parametrize("n", [100, 2304, 3072])
@pytest.mark.parametrize("m", [1, 7, 37, 129, 1600, 2688])
def test_w8a8_kernels_bitwise_at_ragged_shapes(cuda, m, n):
    """M ragged against the 128-row tiles (1 row up to the image pass's
    2688), N ragged against the tile width (100: rows of y not 16-byte
    aligned) and the encoder's QKV / FFN-up widths, K 768."""
    x, wq, ws, b = _w8a8_inputs(cuda, m, 768, n)
    _w8a8_f32_both(x, wq, ws, b)


@pytest.mark.parametrize("m,n", [(37, 100), (129, 2304), (1600, 3072)])
@pytest.mark.parametrize("k", [16, 48, 768, 1536])
def test_w8a8_kernels_bitwise_at_every_depth(cuda, k, m, n):
    """K 16 and 48 fill one 128-byte stage partly (TMA's zeros past K), 768
    is six stages, 1536 is MAX_K (the quantize kernel's 48 values a lane)."""
    x, wq, ws, b = _w8a8_inputs(cuda, m, k, n)
    _w8a8_f32_both(x, wq, ws, b)


def _every_bf16_value():
    """Every finite bf16 value in rows of 768: row e holds binades e, e + 1
    and e + 2 (both signs, all 128 mantissas), so its quotients x / scale
    spread over the int8 range and each value meets three scales."""
    mant = torch.arange(128, dtype=torch.int32)
    rows = []
    for e in range(253):
        mag = (torch.arange(e, e + 3, dtype=torch.int32)[:, None] << 7 | mant[None]).reshape(-1)
        rows.append(torch.cat([mag, mag | 0x8000]))
    return torch.stack(rows).to(torch.int16).view(torch.bfloat16).cuda()


def test_w8a8_quantize_kernel_is_bitwise(cuda):
    """The quantize kernel's xq and xscale equal quantize_rowwise_dynx's
    bitwise: for bf16 and f32 x with an all-zero row (scale 1e-8 / 127) and
    rows of mixed magnitude, and for every finite bf16 value."""
    x = torch.randn(300, 768, generator=cuda, device="cuda")
    x[5] = 0
    x[7] *= 1e4
    x[9] *= 1e-6
    for xt in (x.to(torch.bfloat16), x, _every_bf16_value()):
        before = qm.w8a8_quantize.launches
        xq, xs = qm.w8a8_quantize(xt)
        assert qm.w8a8_quantize.launches == before + 1
        wq, ws = qm.quantize_rowwise_dynx(xt)
        assert xq.dtype == torch.int8 and xs.shape == (xt.shape[0], 1)
        assert torch.equal(xq, wq) and torch.equal(xs, ws)


@pytest.mark.parametrize("activation", [None, "gelu"])
def test_w8a8_rows_do_not_depend_on_m_or_position(cuda, activation):
    """A row's output is the same bits whatever M is and wherever the row
    falls in the tile sweep: rows 1000..1036 and row 2687 of an M 2688 call
    equal those rows called alone (bf16 out, both entries)."""
    x, wq, ws, b = _w8a8_inputs(cuda, 2688, 768, 2304)
    xq, xs = qm.quantize_rowwise(x)
    kw = {"activation": activation}
    full = qm.w8a8_matmul(xq, xs, wq, ws, b, **kw)
    full_dynx = qm.w8a8_matmul_dynx(x, wq, ws, b, **kw)
    for rows in (slice(1000, 1037), slice(2687, 2688), slice(0, 1)):
        assert torch.equal(qm.w8a8_matmul(xq[rows], xs[rows], wq, ws, b, **kw), full[rows])
        assert torch.equal(qm.w8a8_matmul_dynx(x[rows], wq, ws, b, **kw), full_dynx[rows])


def test_w8a8_dynx_takes_f32_x(cuda):
    """K4-dynx on f32 activations: bitwise equal to the plain version at f32
    out without activation, within one bf16 ulp of the largest with gelu."""
    x, wq, ws, b = _w8a8_inputs(cuda, 1601, 768, 2300)
    x = x.float() * 1.5
    xq, xs = qm.quantize_rowwise_dynx(x)
    assert torch.equal(qm.w8a8_matmul_dynx(x, wq, ws, b, out_dtype=torch.float32),
                       qm.w8a8_matmul_plain(xq, xs, wq, ws, b, out_dtype=torch.float32))
    _ulp_close(qm.w8a8_matmul_dynx(x, wq, ws, b, activation="gelu"),
               qm.w8a8_matmul_dynx_plain(x, wq, ws, b, activation="gelu"), torch.bfloat16)


def test_w8a8_kernels_take_empty_m(cuda):
    x, wq, ws, b = _w8a8_inputs(cuda, 0, 768, 2304)
    xq, xs = qm.quantize_rowwise(x)
    assert qm.w8a8_matmul(xq, xs, wq, ws, b).shape == (0, 2304)
    assert qm.w8a8_matmul_dynx(x, wq, ws, b).shape == (0, 2304)


def test_w8a8_kernels_refuse_what_they_cannot_take(cuda):
    x, wq, ws, b = _w8a8_inputs(cuda, 8, 768, 256)
    xq, xs = qm.quantize_rowwise(x)
    with pytest.raises(ValueError, match="int8 activations"):
        qm.w8a8_matmul(x, xs, wq, ws, b)
    with pytest.raises(ValueError, match="bf16 or f32 activations"):
        qm.w8a8_matmul_dynx(x.half(), wq, ws, b)
    with pytest.raises(ValueError, match="multiple of 16"):
        qm.w8a8_matmul_dynx(x[:, :760], wq[:, :760], ws, b)
    big = torch.zeros(8, qm.MAX_K + 16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        qm.w8a8_matmul_dynx(big, torch.zeros(4, qm.MAX_K + 16, device="cuda", dtype=torch.int8),
                            ws[:4])
    with pytest.raises(ValueError, match="bf16 or f32"):
        qm.w8a8_matmul(xq, xs, wq, ws, b, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="int8 wq"):
        qm.w8a8_matmul(xq, xs, wq.float(), ws, b)


@pytest.mark.parametrize("m", [2688, 1600, 7])
def test_residual_layernorm_q8_kernel_matches_plain(cuda, m):
    """K3b against its plain version: y within one bf16 ulp of the largest,
    s within 1e-4 relative (statistics summed in another order), q equal in
    at least 99.9% of elements and never more than one step apart. One
    launch, and K3a's count does not move."""
    x = torch.randn(m, 768, generator=cuda, device="cuda").to(torch.bfloat16)
    res = (0.5 * torch.randn(m, 768, generator=cuda, device="cuda")).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(768, generator=cuda, device="cuda")
    beta = 0.1 * torch.randn(768, generator=cuda, device="cuda")
    before = (lk.residual_layernorm_q8.launches, lk.residual_layernorm_forward.launches)
    y, q, s = lk.residual_layernorm_q8(x, res, gamma, beta)
    assert (lk.residual_layernorm_q8.launches, lk.residual_layernorm_forward.launches) == (
        before[0] + 1, before[1])
    wy, wq, ws = lk.residual_layernorm_q8_plain(x, res, gamma, beta)
    _ulp_close(y, wy, torch.bfloat16)
    assert q.dtype == torch.int8 and s.shape == (m, 1)
    assert ((s - ws).abs() <= 1e-4 * ws.abs()).all()
    assert (q == wq).float().mean().item() >= 0.999
    assert (q.int() - wq.int()).abs().max().item() <= 1


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(33, 100), (37, 1100), (9, 4100)])
def test_residual_layernorm_q8_kernel_takes_any_width(cuda, m, d, x_dtype):
    """K3b at a D that is no multiple of 8 and at Ds above the register
    layout (the rows walked three times), bf16 or f32 x with bf16 res,
    under the gates above (f32 y: 1e-5 of the largest)."""
    x = torch.randn(m, d, generator=cuda, device="cuda").to(x_dtype)
    res = (0.5 * torch.randn(m, d, generator=cuda, device="cuda")).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(d, generator=cuda, device="cuda")
    beta = 0.1 * torch.randn(d, generator=cuda, device="cuda")
    y, q, s = lk.residual_layernorm_q8(x, res, gamma, beta)
    wy, wq, ws = lk.residual_layernorm_q8_plain(x, res, gamma, beta)
    _ulp_close(y, wy, x_dtype)
    assert q.shape == (m, d) and s.shape == (m, 1)
    assert ((s - ws).abs() <= 1e-4 * ws.abs()).all()
    assert (q == wq).float().mean().item() >= 0.999
    assert (q.int() - wq.int()).abs().max().item() <= 1


def test_quant_encoder_launches_its_kernels(cuda):
    """The backbone with quant_matmuls launches K4-dynx twice a layer (QKV,
    FFN-up); with fused_layernorm as well, K3b and K4 twice a layer and
    neither K4-dynx nor K3a. Outputs stay finite and close to the float
    encoder's."""
    from aladin_torch.models.bert_img import BertImgConfig, BertImgModel

    small = dict(vocab_size=97, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=256, max_position_embeddings=64, img_feature_dim=32)
    ids = torch.randint(3, 97, (4, 12), generator=cuda, device="cuda")
    mask = torch.ones(4, 12, dtype=torch.int32, device="cuda")
    ref = BertImgModel(BertImgConfig(**small)).cuda().eval()
    counters = (qm.w8a8_matmul_dynx, qm.w8a8_matmul, lk.residual_layernorm_q8,
                lk.residual_layernorm_forward)
    for knobs, want in (({"quant_matmuls": True}, (4, 0, 0, 0)),
                        ({"quant_matmuls": True, "fused_layernorm": True}, (0, 4, 4, 0))):
        model = BertImgModel(BertImgConfig(**small, **knobs)).cuda().eval()
        model.load_state_dict(ref.state_dict())
        before = [fn.launches for fn in counters]
        with torch.no_grad():
            got, want_out = model(ids, mask)[0], ref(ids, mask)[0]
        assert tuple(fn.launches - b for fn, b in zip(counters, before)) == want, knobs
        assert torch.isfinite(got).all()
        cos = torch.nn.functional.cosine_similarity(got.flatten(1), want_out.flatten(1))
        assert cos.min().item() > 0.99


def _rank_arrays(scores, cpi):
    from aladin_torch.eval.recall import ranks_from_score_matrix

    return tuple(r.cpu().numpy() for r in ranks_from_score_matrix(scores, cpi))


def test_streamed_alignment_ranks_equal_the_kernels_dense_ranks(cuda):
    """bf16 streaming through K1 at a ragged shape (37 images, 185 captions,
    cap_block 50: a padded tail tile and a short ground-truth block) gives
    the ranks of K1's full matrix exactly; one launch a tile and a
    ground-truth block."""
    import numpy as np

    from aladin_torch.eval.streaming import streaming_alignment_ranks
    from aladin_torch.ops.similarity import l2norm

    cpi, n_im = 5, 37
    im, cap, il, cl = _corpus(cuda, n_im, n_im * cpi, 34, 50, 768)
    ims = l2norm(im, eps=1e-12)
    dense = ak.mrsw_scores(ims, l2norm(cap, eps=1e-12), il, cl)
    before = ak.mrsw_scores.launches
    got = streaming_alignment_ranks(im.repeat_interleave(cpi, 0), cap,
                                    il.repeat_interleave(cpi, 0), cl, "MrSw", cpi,
                                    cap_block=50)
    assert ak.mrsw_scores.launches - before == 4 + 4  # ceil(185/50) tiles, ceil(185/50) GT blocks
    for g, w in zip(got, _rank_arrays(dense, cpi)):
        np.testing.assert_array_equal(g, w)


def test_matching_ground_truth_equals_the_tiles_entries(cuda):
    """The f32 ground-truth pass (diagonals of gathered 64 x 64 products)
    equals each caption's entry in its sweep tile (all images x 96
    captions) bit for bit, and the streamed ranks equal the ranks of the
    matrix those tiles make."""
    import numpy as np

    from aladin_torch.eval.streaming import (_matching_tile, matching_ground_truth,
                                             streaming_matching_ranks)

    cpi, n_im, block = 5, 101, 96
    ims = torch.nn.functional.normalize(torch.randn(n_im, 768, generator=cuda, device="cuda"),
                                        dim=1)
    caps = torch.nn.functional.normalize(
        torch.randn(n_im * cpi, 768, generator=cuda, device="cuda"), dim=1)
    gt = matching_ground_truth(ims, caps, cpi, 64)
    tiles = torch.cat([_matching_tile(ims, torch.nn.functional.pad(
        caps[lo:lo + block], (0, 0, 0, block - caps[lo:lo + block].shape[0])))
        for lo in range(0, n_im * cpi, block)], dim=1)[:, :n_im * cpi]
    j = torch.arange(n_im * cpi, device="cuda")
    assert torch.equal(gt, tiles[j // cpi, j])
    got = streaming_matching_ranks(ims, caps, cpi, cap_block=block)
    for g, w in zip(got, _rank_arrays(tiles, cpi)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("direction", ["t2i", "i2t"])
@pytest.mark.parametrize("rerank", [False, True])
def test_search_on_the_card_matches_the_cpu(cuda, direction, rerank):
    """search on CUDA against search on the CPU: indices equal, scores
    within 1e-4 (the same f32 math summed in another order)."""
    import numpy as np

    from aladin_torch.eval.search import build_corpus, search

    rng = np.random.default_rng(0)

    def buffers(n, s):
        embs = rng.standard_normal((n, s, 64)).astype(np.float32)
        return embs / np.linalg.norm(embs, axis=-1, keepdims=True), \
            rng.integers(5, s + 1, size=n).astype(np.int32)

    imgs, img_lens = buffers(50, 20)
    caps, cap_lens = buffers(250, 16)
    corpus, queries = ((imgs, img_lens), (caps, cap_lens)) if direction == "t2i" else \
        ((caps, cap_lens), (imgs, img_lens))
    kw = dict(direction=direction, k=10, shortlist=30, rerank=rerank, query_chunk=16)
    s_gpu, i_gpu = search(build_corpus(*corpus, device="cuda"), *queries, **kw)
    s_cpu, i_cpu = search(build_corpus(*corpus, device="cpu"), *queries, **kw)
    np.testing.assert_array_equal(i_gpu, i_cpu)
    np.testing.assert_allclose(s_gpu, s_cpu, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_device_seed_equals_int_seed(cuda, dtype):
    """K2 reads its seed through a pointer: a seed tensor on the card gives
    the bits of the same int seed, forward and backward, and another seed
    another mask."""
    q, k, v, bias, g = _attention_inputs(cuda, 8, 50, 1, dtype)
    seed = torch.tensor(123457, dtype=torch.int64, device="cuda")
    for fn, extra in ((at.attention_forward, ()), (at.attention_backward, (g,))):
        by_int = fn(q, k, v, bias, *extra, 123457, 0.1, True)
        by_tensor = fn(q, k, v, bias, *extra, seed, 0.1, True)
        other = fn(q, k, v, bias, *extra, seed + 1, 0.1, True)
        for a, b, c in zip(*(t if isinstance(t, tuple) else (t,)
                             for t in (by_int, by_tensor, other))):
            assert torch.equal(a, b)
            assert not torch.equal(a, c)
    # a seed of the int32 range as int32, and one past 2^32 (its low bits)
    assert torch.equal(at.attention_forward(q, k, v, bias, seed.int(), 0.1, True),
                       at.attention_forward(q, k, v, bias, 123457, 0.1, True))
    assert torch.equal(at.attention_forward(q, k, v, bias, 2 ** 32 + 5, 0.1, True),
                       at.attention_forward(q, k, v, bias, 5, 0.1, True))


def _small_train(dropout, chunk=0, seed=0, training=None, **bert_knobs):
    """(model, state) at a small width the kernels take (heads of 64), both
    kernel knobs on, weights from ``seed``; ``training``: more recipe keys;
    ``bert_knobs``: more BertImgConfig fields (``remat``)."""
    from aladin_torch.config import ExperimentConfig
    from aladin_torch.models.aladin import ALADIN
    from aladin_torch.models.bert_img import BertImgConfig
    from aladin_torch.train.state import TrainState

    cfg = ExperimentConfig.from_dict({
        "model": {"embed-size": 128, "tern-layers": 1, "dropout": dropout},
        "training": {"loss-type": "alignment-distillation", "loss-weights": [1, 1],
                     "lr": 1e-3, "bs": 8, "grad-clip": 2.0, "alignment-chunk": chunk,
                     "activate-distillation-after": 1, **(training or {})}})
    bert = BertImgConfig(vocab_size=97, hidden_size=128, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=256,
                         max_position_embeddings=64, img_feature_dim=40,
                         hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout,
                         fused_attention=True, fused_layernorm=True, **bert_knobs)
    model = ALADIN(cfg, bert)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.cuda().train()
    return model, TrainState(cfg, model, steps_per_epoch=3)


def _small_batches(n, b=8, l=16, r=6):
    from aladin_torch.models.aladin import Batch

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for _ in range(n):
        def ints(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)

        cap_len, img_len, lab_len = ints(5, l + 1, (b,)), ints(2, r + 1, (b,)), ints(2, l + 1, (b,))
        pl, pr = torch.arange(l, device="cuda")[None], torch.arange(r, device="cuda")[None]
        out.append(Batch(
            txt_ids=ints(3, 97, (b, l)), txt_mask=(pl < cap_len[:, None]).int(),
            txt_type=torch.zeros(b, l, dtype=torch.int32, device="cuda"), cap_len=cap_len,
            img_ids=ints(3, 97, (b, l)),
            img_mask=torch.cat([pl < lab_len[:, None], pr < img_len[:, None]], dim=1).int(),
            img_type=torch.ones(b, l, dtype=torch.int32, device="cuda"),
            img_feats=torch.randn(b, r, 40, generator=gen, device="cuda"), img_len=img_len))
    return out


@pytest.mark.parametrize("dropout,chunk", [(0.0, 0), (0.0, 3), (0.1, 0)])
def test_graphed_window_equals_eager_steps(cuda, dropout, chunk):
    """A CUDA graph of 4 steps, replayed twice (8 steps, across the
    distillation gate's epoch and a schedule decay), against 8 eager steps
    from the same state and the same CUDA generator state: metrics,
    parameters and Adam moments bit for bit, dropout on or off, with the
    checkpointed alignment chunks inside the capture. The first call
    captures (its warm-up step is undone) and replays; the second only
    replays, so the Python launch counters do not move."""
    from aladin_torch.train.step import make_multi_train_step, make_train_step

    batches = _small_batches(8)
    decay = {"step-size": 1, "gamma": 0.5}  # the lr halves every epoch of 3 steps
    eager_model, eager = _small_train(dropout, chunk, training=decay)
    graph_model, graphed = _small_train(dropout, chunk, training=decay)
    assert len({eager.schedule(i) for i in range(8)}) == 3
    step = make_train_step(eager_model, eager.cfg, torch.bfloat16)
    torch.cuda.manual_seed(5)
    singles = [step(eager, b, i // 4) for i, b in enumerate(batches)]
    multi = make_multi_train_step(graph_model, graphed.cfg, torch.bfloat16, k=4)
    torch.cuda.manual_seed(5)
    windows = [multi(graphed, batches[:4], 0)]
    before = (at.attention_forward.launches, lk.residual_layernorm_backward.launches)
    windows.append(multi(graphed, batches[4:], 1))
    assert (at.attention_forward.launches, lk.residual_layernorm_backward.launches) == before
    assert multi.window.n == 4
    assert graphed.step == eager.step == 8
    for name in singles[0]:
        got = torch.cat([w[name] for w in windows])
        assert torch.equal(got, torch.stack([m[name] for m in singles])), name
    for p, q in zip(graphed.trainable, eager.trainable):
        assert torch.equal(p, q)
        for key, v in eager.optimizer.state[q].items():
            assert torch.equal(graphed.optimizer.state[p][key], v), key


def test_remat_equals_no_remat_on_the_card(cuda):
    """One eager step at bs 32, dropout 0.1, from the same weights and CUDA
    generator state, with and without remat: metrics and params bit for bit
    (the recompute regenerates K2's masks from the same seed tensors and
    the plain dropouts from the restored generator). Under remat K2 and
    K3a launch their forwards twice a layer call (forward, recompute) and
    their backwards once."""
    from aladin_torch.train.step import make_train_step

    (batch,) = _small_batches(1, b=32)
    counters = (at.attention_forward, at.attention_backward, lk.residual_layernorm_forward,
                lk.residual_layernorm_backward)
    runs = {}
    for remat in (False, True):
        model, state = _small_train(0.1, remat=remat)
        step = make_train_step(model, state.cfg, torch.bfloat16)
        torch.cuda.manual_seed(9)
        before = [c.launches for c in counters]
        metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        runs[remat] = (metrics, [p.detach().clone() for p in state.trainable],
                       [c.launches - b for c, b in zip(counters, before)])
    (m0, p0, n0), (m1, p1, n1) = runs[False], runs[True]
    for name in m0:
        assert torch.equal(m0[name], m1[name]), name
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    layers = 2 * 2  # two passes of two layers
    assert n0 == [layers, layers, 2 * layers, 2 * layers]
    assert n1 == [2 * layers, layers, 4 * layers, 2 * layers]


@pytest.mark.parametrize("lever", ["remat", "microbatch", "both"])
def test_graphed_window_with_a_lever_equals_eager_steps(cuda, lever):
    """The levers inside a CUDA graph: non-reentrant checkpoint stashes and
    restores the CUDA generator's state inside the capture. A graph of 4
    steps at dropout 0.1 against 4 eager steps: metrics and params bit for
    bit."""
    from aladin_torch.train.step import make_multi_train_step, make_train_step

    batches = _small_batches(4)
    training = {"encoder-microbatch": 4} if lever != "remat" else None
    remat = lever != "microbatch"
    eager_model, eager = _small_train(0.1, training=training, remat=remat)
    graph_model, graphed = _small_train(0.1, training=training, remat=remat)
    step = make_train_step(eager_model, eager.cfg, torch.bfloat16)
    torch.cuda.manual_seed(5)
    singles = [step(eager, b, 0) for b in batches]
    multi = make_multi_train_step(graph_model, graphed.cfg, torch.bfloat16, k=4)
    torch.cuda.manual_seed(5)
    window = multi(graphed, batches, 0)
    assert multi.window is not None
    for name in singles[0]:
        assert torch.equal(window[name], torch.stack([m[name] for m in singles])), name
    for p, q in zip(graphed.trainable, eager.trainable):
        assert torch.equal(p, q)


def test_graph_replays_draw_new_attention_seeds(cuda, monkeypatch):
    """K2's seeds are drawn inside the graph: two replays use other seeds."""
    from aladin_torch.train.step import make_multi_train_step

    seen = []
    launch = at.attention_forward

    def recording(q, k, v, bias, seed=0, *args):
        if torch.is_tensor(seed):
            seen.append(seed.clone())
        return launch(q, k, v, bias, seed, *args)

    recording.launches = 0  # the wrapper's body counts on the name it is called by
    monkeypatch.setattr(at, "attention_forward", recording)
    model, state = _small_train(0.1)
    multi = make_multi_train_step(model, state.cfg, torch.bfloat16, k=2)
    batches = _small_batches(2)
    multi(state, batches, 0)
    captured = seen[-8:]  # 2 steps x 2 passes x 2 layers, the capture's
    first = torch.stack(captured).cpu()
    multi(state, batches, 0)
    second = torch.stack(captured).cpu()
    assert first.unique().numel() == 8
    assert not torch.equal(first, second)


def test_graph_remainder_runs_single_steps(cuda):
    """A window shorter than k (an epoch's remainder) after a captured
    window runs as single eager steps, with no second capture: 4 + 2 steps
    equal 6 eager steps bit for bit."""
    from aladin_torch.train.step import make_multi_train_step, make_train_step

    batches = _small_batches(6)
    eager_model, eager = _small_train(0.0)
    graph_model, graphed = _small_train(0.0)
    step = make_train_step(eager_model, eager.cfg, torch.bfloat16)
    singles = [step(eager, b, 0) for b in batches]
    multi = make_multi_train_step(graph_model, graphed.cfg, torch.bfloat16, k=4)
    windows = [multi(graphed, batches[:4], 0)]
    window, before = multi.window, at.attention_forward.launches
    windows.append(multi(graphed, batches[4:], 0))
    assert multi.window is window and window.n == 4
    assert at.attention_forward.launches == before + 2 * 2 * 2  # steps x passes x layers
    assert graphed.step == eager.step == 6
    for name in singles[0]:
        got = torch.cat([w[name] for w in windows])
        assert torch.equal(got, torch.stack([m[name] for m in singles])), name
    for p, q in zip(graphed.trainable, eager.trainable):
        assert torch.equal(p, q)


def test_capturable_adam_equals_torch_eager_adam(cuda):
    """The card state's optimizer, Adam(capturable=True) with its lr in a
    device tensor (the eager step's as well as the graph's), against torch's
    non-capturable Adam with a float lr, from the same parameters and the
    same clipped gradients over 6 steps through the schedule's decay:
    moments bit for bit, parameters to 1e-6 relative and 2e-7 absolute. The
    capturable form computes the bias corrections in f32 on the card, as
    optax does, the eager one in double on the host: 1 - 0.999 in f32 is
    1.3e-5 off, so each update differs by up to ~7e-6 of itself, and 6
    updates of at most 1e-3 x |m / sqrt(v)| (<= 3 here) by under 2e-7."""
    _, state = _small_train(0.0, seed=6, training={"step-size": 1, "gamma": 0.5})
    group = state.optimizer.param_groups[0]
    assert state.capturable and group["capturable"] and torch.is_tensor(group["lr"])
    ref_params = [p.detach().clone().requires_grad_(True) for p in state.trainable]
    ref = torch.optim.Adam(ref_params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    assert not ref.param_groups[0]["capturable"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    lrs = []
    for _ in range(6):
        lrs.append(state.schedule(state.schedule_step))
        for p in state.trainable:
            p.grad = torch.randn(p.shape, generator=gen, device="cuda")
        state.apply_gradients()
        for p, q in zip(state.trainable, ref_params):
            q.grad = p.grad.clone()  # the clip scaled it in place
        ref.param_groups[0]["lr"] = lrs[-1]
        ref.step()
    assert len(set(lrs)) > 1
    for p, q in zip(state.trainable, ref_params):
        torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-6, atol=2e-7)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state.optimizer.state[p][key], ref.state[q][key]), key


def test_native_loader_on_the_card(cuda, tmp_path):
    """The loader through the native reader and tokenizer gives the pure
    Python path's batches on the card, bit for bit."""
    import os

    from aladin_torch.cli.common import build_tokenizer
    from aladin_torch.config import DataArgs
    from aladin_torch.data.dataset import RetrievalDataset, make_synthetic_dataset
    from aladin_torch.data.pipeline import BatchLoader
    from aladin_torch.data.tokenizer import BertWordPieceTokenizer

    make_synthetic_dataset(str(tmp_path), n_images=20, feat_dim=64)
    args = DataArgs(data_dir=str(tmp_path), img_feat_file=os.path.join(tmp_path, "features.tsv"),
                    max_seq_length=24, max_img_seq_length=10, img_feature_dim=64,
                    add_od_labels=True)
    tok = build_tokenizer(args)
    fast = RetrievalDataset(tok, args, "train", is_train=False)
    slow = RetrievalDataset(BertWordPieceTokenizer(tok.vocab), args, "train", is_train=False,
                            use_native_io=False)
    assert tok.native_enabled and fast.native_enabled and not slow.native_enabled
    for a, b in zip(BatchLoader(fast, 16, shuffle=False, device="cuda").epoch(0),
                    BatchLoader(slow, 16, shuffle=False, device="cuda").epoch(0)):
        for f in a.__dataclass_fields__:
            assert getattr(a, f).is_cuda
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_graphed_state_resumes_on_the_card_and_on_the_cpu(cuda, tmp_path):
    """A checkpoint of a capturable state after a graphed window resumes
    into a fresh card state whose next eager step equals the original's bit
    for bit, and into a CPU state (the eager optimizer) that steps."""
    from aladin_torch.io.checkpoint import resume_state, save_checkpoint
    from aladin_torch.models.aladin import Batch
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_multi_train_step, make_train_step

    batches = _small_batches(3)
    model, state = _small_train(0.0, seed=4)
    make_multi_train_step(model, state.cfg, torch.bfloat16, k=2)(state, batches[:2], 0)
    path = save_checkpoint(str(tmp_path), state, 1, state.cfg.to_dict(), 0.0)
    card_model, card = _small_train(0.0, seed=9)
    card, _, _ = resume_state(card, path)
    assert card.step == state.step == 2 and card.capturable
    make_train_step(model, state.cfg, torch.bfloat16)(state, batches[2], 1)
    make_train_step(card_model, card.cfg, torch.bfloat16)(card, batches[2], 1)
    for p, q in zip(state.trainable, card.trainable):
        assert torch.equal(p, q)

    cpu_model = _small_train(0.0, seed=9)[0].cpu()
    cpu = TrainState(state.cfg, cpu_model, steps_per_epoch=3)
    cpu, _, _ = resume_state(cpu, path)
    assert not cpu.capturable and isinstance(cpu.optimizer.param_groups[0]["lr"], float)
    cpu_batch = Batch(**{f: getattr(batches[2], f).cpu() for f in Batch.__dataclass_fields__})
    metrics = make_train_step(cpu_model, cpu.cfg)(cpu, cpu_batch, 1)
    assert all(torch.isfinite(v) for v in metrics.values())
