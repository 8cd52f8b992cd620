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
    """bf16: within one bf16 ulp of the largest output (the same f32 math
    with sums in another order, then one rounding to bf16). f32: 1e-5 of
    the largest output (no rounding, only the order of the sums)."""
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
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
