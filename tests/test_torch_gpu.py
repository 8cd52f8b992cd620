"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA device and nvcc:

    python -m pytest tests/test_torch_gpu.py -m gpu

Without a card every test skips (the kernels have no CPU mode); the CPU
parity of the plain versions with aladin_tpu is in tests/test_torch_*.py.
"""

import dataclasses
import itertools
import math

import pytest
import torch

from aladin_torch.eval.retrieval import score_by_caption_bucket
from aladin_torch.ops.kernels import alignment_kernel as ak
from aladin_torch.ops.kernels import attention_kernel as at
from aladin_torch.ops.kernels import layernorm as lk
from aladin_torch.ops.kernels import quant_matmul as qm
from aladin_torch.utils import profiling

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA and Triton kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _launches(*names):
    """The named kernel launch counters of ``utils/profiling.py``."""
    c = profiling.counters()
    return tuple(c[n] for n in names)


def _corpus(gen, n_im, n_cap, s_im, s_s, d):
    return (torch.randn(n_im, s_im, d, generator=gen, device="cuda"),
            torch.randn(n_cap, s_s, d, generator=gen, device="cuda"),
            torch.randint(2, s_im + 1, (n_im,), generator=gen, device="cuda"),
            torch.randint(4, s_s + 1, (n_cap,), generator=gen, device="cuda"))


# (n_im, n_cap, S_im, S_s, D): small, the benchmark's widths (R 33: the tail
# pass), D off 128 bytes; R 1 / W 1; R 8 / W 16; the main path's R 50 / W 13
# (the tail); R 128 / W 128; an image count that is no multiple of a group;
# R 34 (the tail, no padded slot) and R 35 (a slab for 3 slots); R 10 (one
# slab, then the tail), D off 128 bytes
_MRSW_SHAPES = [(7, 11, 5, 6, 128), (37, 53, 34, 50, 768), (5, 9, 129, 20, 200),
                (9, 13, 2, 4, 768), (17, 29, 9, 19, 768), (8, 33, 51, 16, 768),
                (3, 5, 129, 131, 768), (1001, 70, 34, 50, 768), (37, 53, 35, 50, 768),
                (37, 53, 36, 50, 768), (13, 17, 11, 20, 200)]


@pytest.mark.parametrize("shape", _MRSW_SHAPES)
def test_mrsw_kernel_matches_plain(cuda, shape):
    """bf16: atol 1e-3 (same bf16 products, f32 sums in another order;
    observed ~4e-6 at D=768). int8: relative 1e-5 (identical integer sums,
    only the descale rounds). One launch per call."""
    args = _corpus(cuda, *shape)
    for dt in (torch.bfloat16, torch.int8):
        before = _launches("k1.launches")
        got = ak.mrsw_scores(*args, compute_dtype=dt)
        assert _launches("k1.launches") == (before[0] + 1,)
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


def test_mrsw_kernel_zero_floor_in_the_tail(cuda):
    """R 33: image 2 has 32 regions, so its one zero slot inside R, slot 32,
    lies in the tail pass; word 1 of caption 0 points against its regions
    and image 0's (full, no floor). Tolerances as above."""
    im, cap, il, sl = _corpus(cuda, 11, 3, 34, 50, 768)
    il[0], il[2] = 34, 33
    cap[0, 1] = -(im[0, 1:].sum(0) + im[2, 1:33].sum(0))
    for dt in (torch.bfloat16, torch.int8):
        got = ak.mrsw_scores(im, cap, il, sl, compute_dtype=dt)
        want = ak.mrsw_scores_plain(im, cap, il, sl, compute_dtype=dt)
        if dt == torch.bfloat16:
            torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
        else:
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("r", [1, 8, 10, 33, 34, 35, 50])
def test_mrsw_kernel_counts_slots(cuda, r):
    """One launch a call; ``mrsw.valid_slots`` counts N_im x R and
    ``mrsw.multiplied_slots`` 8 x groups x the slots a group multiplies: 8
    floor(R / 8) + 2 through the tail for R mod 8 in {1, 2} past the first
    8, R rounded up to 8 else."""
    args = _corpus(cuda, 21, 30, r + 1, 20, 768)
    slots = -(-r // 2) * 2 if r > 8 and r % 8 in (1, 2) else -(-r // 8) * 8
    for dt in (torch.bfloat16, torch.int8):
        names = ("k1.launches", "mrsw.valid_slots", "mrsw.multiplied_slots")
        before = _launches(*names)
        ak.mrsw_scores(*args, compute_dtype=dt)
        after = _launches(*names)
        assert tuple(b - a for a, b in zip(before, after)) == (1, 21 * r, 24 * slots)


@pytest.mark.parametrize("s_im", [34, 35])  # R 33 and 34: the tail pass
def test_mrsw_kernel_bucketed_equals_unbucketed(cuda, s_im):
    """bf16 bucketing drops only zero words, which the kernel sums after the
    real ones: the scores are bitwise equal."""
    im, cap, il, _ = _corpus(cuda, 300, 700, s_im, 50, 768)
    sl = torch.randint(4, 51, (700,), generator=cuda, device="cuda")
    full = ak.mrsw_scores(im, cap, il, sl)
    assert torch.equal(ak.mrsw_scores_bucketed(im, cap, il, sl), full)


def test_mrsw_kernel_score_is_shape_independent(cuda):
    args = _corpus(cuda, 40, 70, 34, 50, 768)
    full = ak.mrsw_scores(*args)
    part = ak.mrsw_scores(args[0][3:17], args[1][5:61], args[2][3:17], args[3][5:61])
    assert torch.equal(part, full[3:17, 5:61])


def _coco_lengths(n, seed=0):
    """Caption token counts as the score benchmark draws them: round(9 +
    Gamma(2, 2.5)), clipped to 8..50."""
    import numpy as np

    g = np.random.RandomState(seed).gamma(2.0, 2.5, n)
    return torch.as_tensor(np.clip(np.round(9 + g), 8, 50), device="cuda").long()


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.int8])
def test_mrsw_kernel_packed_coco_mix(cuda, dt):
    """A COCO-like length mix packs several captions a tile, straddling the
    epilogue's column quarters: K1 against the plain version (tolerances as
    above), one launch a bucketed call, and bucketed int8 equals a plain
    call a bucket with that bucket's scale bit for bit but for the sums."""
    im, cap, il, _ = _corpus(cuda, 45, 2000, 34, 50, 768)
    sl = _coco_lengths(2000)
    got = ak.mrsw_scores(im, cap, il, sl, compute_dtype=dt)
    want = ak.mrsw_scores_plain(im, cap, il, sl, compute_dtype=dt)
    if dt == torch.bfloat16:
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    else:
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    before = _launches("k1.launches")
    got = ak.mrsw_scores_bucketed(im, cap, il, sl, compute_dtype=dt)
    assert _launches("k1.launches") == (before[0] + 1,)
    plain = lambda *a: ak.mrsw_scores_plain(*a, compute_dtype=dt)  # noqa: E731
    want = score_by_caption_bucket(plain, im, cap, il, sl)
    if dt == torch.bfloat16:
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    else:
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_mrsw_kernel_caption_score_independent_of_its_tile(cuda):
    """A caption's bf16 score is bitwise the same scored alone, among 700
    captions of mixed lengths (1..128 words), and with their order
    reversed: its place in its tile and its neighbours do not enter."""
    im, cap, il, _ = _corpus(cuda, 19, 700, 34, 131, 768)
    sl = torch.randint(4, 132, (700,), generator=cuda, device="cuda")
    mixed = ak.mrsw_scores(im, cap, il, sl)
    flipped = ak.mrsw_scores(im, cap.flip(0), il, sl.flip(0)).flip(1)
    assert torch.equal(mixed, flipped)
    for c in (0, 17, 350, 699):
        alone = ak.mrsw_scores(im, cap[c:c + 1], il, sl[c:c + 1])
        assert torch.equal(alone[:, 0], mixed[:, c])


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.int8])
def test_mrsw_kernel_zero_and_128_word_captions(cuda, dt):
    """Captions of 0 valid words (3 tokens or fewer) score exactly 0 and
    those of 128 (a buffer of 131) fill half a tile; both against the plain
    version, tolerances as above."""
    im, cap, il, _ = _corpus(cuda, 21, 40, 34, 131, 768)
    sl = torch.tensor([3, 131, 0, 131, 2] + [131, 40, 3, 17, 1] * 7, device="cuda")
    got = ak.mrsw_scores(im, cap, il, sl, compute_dtype=dt)
    want = ak.mrsw_scores_plain(im, cap, il, sl, compute_dtype=dt)
    assert torch.equal(got[:, sl <= 3], torch.zeros_like(got[:, sl <= 3]))
    if dt == torch.bfloat16:
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    else:
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


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
    before = _launches("k2.fwd_launches", "k2.bwd_launches")
    _ulp_close(at.attention_forward(*args, 5, rate, True),
               at.attention_forward_plain(*args, 5, rate, True), dtype)
    if backward:
        for got, want in zip(at.attention_backward(*args, g, 5, rate, True),
                             at.attention_backward_plain(*args, g, 5, rate, True)):
            _ulp_close(got, want, dtype)
    assert _launches("k2.fwd_launches", "k2.bwd_launches") == (
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


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b", [16, 32])
def test_attention_kernels_match_plain_under_caption_masks(cuda, b, rate):
    """bf16 K2 at the decoder's (B 16) and the captioning step's (B 32)
    shape: S 120 = 40 caption slots + 30 OD labels + 50 regions under
    per-row block masks (tasks/captioning.py::_decode_attention_mask), OD
    and region lengths drawn per row, so the padded label and region rows
    are fully masked, and one row with neither OD labels nor regions. The
    2-D forward takes several heads a block here (plan_fwd: three halves
    of heads at B 16, three heads at B 32)."""
    import numpy as np

    from aladin_torch.tasks.captioning import _decode_attention_mask

    rng = np.random.RandomState(b)
    lens = [(int(o), int(r)) for o, r in zip(rng.randint(1, 31, b), rng.randint(10, 51, b))]
    lens[1] = (0, 0)
    masks = np.stack([_decode_attention_mask(40, 70, 50, o, r) for o, r in lens])
    bias = (1.0 - torch.from_numpy(masks).float().cuda()) * -10000.0
    q, k, v, _, g = _attention_inputs(cuda, b, 120, 1, torch.bfloat16)
    _attention_matches_plain(q, k, v, bias, g, rate, torch.bfloat16)


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
    before = _launches("k3a.fwd_launches")
    y, mean, rstd = lk.residual_layernorm_forward(x, res, gamma, beta)
    assert _launches("k3a.fwd_launches") == (before[0] + 1,)
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
    before = _launches("k3a.bwd_launches")
    got = lk.residual_layernorm_backward(*args)
    assert _launches("k3a.bwd_launches") == (before[0] + 1,)
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
    before = _launches("k3a.fwd_launches", "k3a.bwd_launches")
    lk.residual_layernorm(*leaves).backward(gy)
    assert _launches("k3a.fwd_launches", "k3a.bwd_launches") == (before[0] + 1, before[1] + 1)
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
    before = _launches("k4.launches", "k4_dynx.launches")
    kw = {"activation": activation, "out_dtype": out_dtype}
    pairs = ((qm.w8a8_matmul(xq, xs, wq, ws, b, **kw),
              qm.w8a8_matmul_plain(xq, xs, wq, ws, b, **kw)),
             (qm.w8a8_matmul_dynx(x, wq, ws, b, **kw),
              qm.w8a8_matmul_dynx_plain(x, wq, ws, b, **kw)))
    assert _launches("k4.launches", "k4_dynx.launches") == (before[0] + 1, before[1] + 1)
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
        before = _launches("k4.quantize_launches")
        xq, xs = qm.w8a8_quantize(xt)
        assert _launches("k4.quantize_launches") == (before[0] + 1,)
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
    before = _launches("k3b.launches", "k3a.fwd_launches")
    y, q, s = lk.residual_layernorm_q8(x, res, gamma, beta)
    assert _launches("k3b.launches", "k3a.fwd_launches") == (before[0] + 1, before[1])
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
    counters = ("k4_dynx.launches", "k4.launches", "k3b.launches", "k3a.fwd_launches")
    for knobs, want in (({"quant_matmuls": True}, (4, 0, 0, 0)),
                        ({"quant_matmuls": True, "fused_layernorm": True}, (0, 4, 4, 0))):
        model = BertImgModel(BertImgConfig(**small, **knobs)).cuda().eval()
        model.load_state_dict(ref.state_dict())
        before = _launches(*counters)
        with torch.no_grad():
            got, want_out = model(ids, mask)[0], ref(ids, mask)[0]
        assert tuple(n - b for n, b in zip(_launches(*counters), before)) == want, knobs
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
    before = _launches("k1.launches")[0]
    got = streaming_alignment_ranks(im.repeat_interleave(cpi, 0), cap,
                                    il.repeat_interleave(cpi, 0), cl, "MrSw", cpi,
                                    cap_block=50)
    # ceil(185/50) tiles, ceil(185/50) GT blocks
    assert _launches("k1.launches")[0] - before == 4 + 4
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
    before = _launches("k2.fwd_launches", "k3a.bwd_launches")
    windows.append(multi(graphed, batches[4:], 1))
    assert _launches("k2.fwd_launches", "k3a.bwd_launches") == before
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
    counters = ("k2.fwd_launches", "k2.bwd_launches", "k3a.fwd_launches", "k3a.bwd_launches")
    runs = {}
    for remat in (False, True):
        model, state = _small_train(0.1, remat=remat)
        step = make_train_step(model, state.cfg, torch.bfloat16)
        torch.cuda.manual_seed(9)
        before = _launches(*counters)
        metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        runs[remat] = (metrics, [p.detach().clone() for p in state.trainable],
                       [n - b for n, b in zip(_launches(*counters), before)])
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


def test_captured_window_opens_its_spans(cuda, tmp_path):
    """The first window of K batches captures the graph once
    (``step.captures`` + 1); a traced replay opens ``step.fill``,
    ``step.replay`` and ``step.metrics`` and captures nothing again (the
    traced tally of ``step.captures`` stays 0)."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from aladin_torch.train.step import make_multi_train_step

    model, state = _small_train(0.0)
    multi = make_multi_train_step(model, state.cfg, torch.bfloat16, k=2)
    batches = _small_batches(2)
    captures = profiling.counters()["step.captures"]
    multi(state, batches, 0)
    assert profiling.counters()["step.captures"] == captures + 1
    profiling.reset_counters()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            multi(state, batches, 0)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    for name in ("step.fill", "step.replay", "step.metrics"):
        assert names.count(name) == 2, (name, names)
    assert "step.capture" not in names and "step.eager" not in names
    assert profiling.counters()["step.captures"] == captures + 1
    assert profiling.counters(traced=True)["step.captures"] == 0


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
    window, before = multi.window, _launches("k2.fwd_launches")[0]
    windows.append(multi(graphed, batches[4:], 0))
    assert multi.window is window and window.n == 4
    assert _launches("k2.fwd_launches")[0] == before + 2 * 2 * 2  # steps x passes x layers
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


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL process group on this card and its mesh (the
    single-card form of a data-parallel run; the two-rank parity runs on
    gloo in tests/test_torch_parallel.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    import socket

    import torch.distributed as dist

    from aladin_torch.parallel.distributed import initialize, shutdown
    from aladin_torch.parallel.mesh import create_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0, device="cuda")
    assert dist.get_backend() == "nccl"
    yield create_mesh("dp=1")
    shutdown()


def test_sharded_scorer_on_a_one_rank_nccl_group(cuda, nccl_mesh):
    """sharded_mrsw_scores (no small-corpus fallback) launches K1 once a call
    and equals mrsw_scores bit for bit in bf16 (K1's scores do not depend
    on the corpus shape) and within 1e-5 relative in int8 (its scales are
    the shard's); sharded_matching_scores equals the f32 product bit for bit."""
    from aladin_torch.parallel.mesh import sharded_matching_scores, sharded_mrsw_scores

    args = _corpus(cuda, 37, 301, 34, 50, 768)
    for dt in (torch.bfloat16, torch.int8):
        before = _launches("k1.launches")
        got = sharded_mrsw_scores(nccl_mesh, *args, compute_dtype=dt, small_corpus_fallback=False)
        assert _launches("k1.launches") == (before[0] + 1,)
        want = ak.mrsw_scores(*args, compute_dtype=dt)
        if dt == torch.bfloat16:
            assert torch.equal(got, want)
        else:
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    ims, caps = args[0][:, 0], args[1][:, 0]
    assert torch.equal(sharded_matching_scores(nccl_mesh, ims, caps), ims @ caps.T)


def test_dp_step_on_a_one_rank_nccl_group_equals_the_plain_step(cuda, nccl_mesh):
    """The data-parallel step (gathers, their backward all-reduces, the flat
    gradient all-reduce) on one rank equals the plain step bit for bit, knobs
    on, dropout 0, over 3 steps."""
    from aladin_torch.train.step import make_train_step

    batches = _small_batches(3)
    plain_model, plain = _small_train(0.0, 0)
    dp_model, dp = _small_train(0.0, 0)
    step = make_train_step(plain_model, plain.cfg, torch.bfloat16)
    dp_step = make_train_step(dp_model, dp.cfg, torch.bfloat16, nccl_mesh)
    for b in batches:
        want, got = step(plain, b, 0), dp_step(dp, b, 0)
        for name in want:
            assert torch.equal(got[name], want[name]), name
    for p, q in zip(dp.trainable, plain.trainable):
        assert torch.equal(p, q)


def test_dp_graphed_window_equals_eager_dp_steps(cuda, nccl_mesh):
    """A CUDA graph of 4 data-parallel steps, with the NCCL collectives
    captured inside it, replayed twice, against 8 eager data-parallel steps:
    metrics, parameters and Adam moments bit for bit."""
    from aladin_torch.train.step import make_multi_train_step, make_train_step

    batches = _small_batches(8)
    eager_model, eager = _small_train(0.0, 0)
    graph_model, graphed = _small_train(0.0, 0)
    step = make_train_step(eager_model, eager.cfg, torch.bfloat16, nccl_mesh)
    singles = [step(eager, b, 0) for b in batches]
    multi = make_multi_train_step(graph_model, graphed.cfg, torch.bfloat16, k=4, mesh=nccl_mesh)
    windows = [multi(graphed, batches[:4], 0), multi(graphed, batches[4:], 0)]
    for name in singles[0]:
        got = torch.cat([w[name] for w in windows])
        assert torch.equal(got, torch.stack([m[name] for m in singles])), name
    for p, q in zip(graphed.trainable, eager.trainable):
        assert torch.equal(p, q)
        for key, v in eager.optimizer.state[q].items():
            assert torch.equal(graphed.optimizer.state[p][key], v), key


def test_token_type_gradient_repeats_itself_past_3072_indices(cuda):
    """The token-type rows' gradient is a fixed-order reduction: two
    backwards over 128 x 50 ids give the same bits, and the forward equals
    the embedding lookup's."""
    from aladin_torch.models.bert_img import select_rows

    gen = torch.Generator(device="cuda").manual_seed(3)
    table = torch.randn(2, 768, generator=gen, device="cuda", requires_grad=True)
    ids = torch.randint(0, 2, (128, 50), generator=gen, device="cuda")
    g = torch.randn(128, 50, 768, generator=gen, device="cuda")
    out = select_rows(table, ids)
    assert torch.equal(out, torch.nn.functional.embedding(ids, table))
    first, = torch.autograd.grad(out, table, g)
    second, = torch.autograd.grad(select_rows(table, ids), table, g)
    assert torch.equal(first, second)


def _pretrain_pair(dropout):
    """A 4-layer, width-256 pretraining model (heads of 64, the K2 width)
    on the card with both kernel knobs, its bf16 AdamW step, and a batch of
    8 x (35 text + 50 regions): the pretraining stream's S 85."""
    import dataclasses

    from aladin_torch.cli.pretrain import make_optimizer
    from aladin_torch.models.bert_img import BertImgConfig, init_weights
    from aladin_torch.tasks.pretraining import BertImgForPreTraining, make_pretrain_step

    cfg = BertImgConfig(vocab_size=1000, hidden_size=256, num_hidden_layers=4,
                        num_attention_heads=4, intermediate_size=1024, img_feature_dim=2054,
                        hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    models, start = [], None
    for fused in (True, False):
        m = BertImgForPreTraining(dataclasses.replace(cfg, fused_attention=fused,
                                                      fused_layernorm=fused))
        if start is None:
            init_weights(m, torch.Generator().manual_seed(0), 0.02)
            start = m.state_dict()
        m.load_state_dict(start)
        m.cuda()
        opt, _ = make_optimizer(m, 1e-4, 0, 10)
        models.append((m, make_pretrain_step(m, opt, torch.bfloat16)))
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(5, 1000, (8, 35), generator=gen, device="cuda")
    mask = torch.ones(8, 85, dtype=torch.int32, device="cuda")
    mask[:4, 20:35] = 0
    seg = torch.zeros_like(ids)
    feats = torch.randn(8, 50, 2054, generator=gen, device="cuda")
    lm = torch.where(torch.rand(8, 85, generator=gen, device="cuda") < 0.15,
                     torch.randint(0, 1000, (8, 85), generator=gen, device="cuda"), -1)
    lm[:, 35:] = -1
    nxt = torch.randint(0, 2, (8,), generator=gen, device="cuda")
    return models, (ids, mask, seg, feats, lm, nxt)


def test_pretrain_step_with_the_kernels_matches_the_plain_step(cuda):
    """One pretraining step at dropout 0 with K2 and K3a against the plain
    step from the same weights: loss within 1e-2 and the gradient norm within
    5e-2 (chip_smoke.py's knob tolerances: the fused residual stream stays in
    bf16); one K2 forward and backward and two K3a forwards and backwards a
    layer."""
    from aladin_torch.train.schedule import global_norm

    ((on, step_on), (off, step_off)), batch = _pretrain_pair(0.0)
    counters = ("k2.fwd_launches", "k2.bwd_launches", "k3a.fwd_launches", "k3a.bwd_launches")
    before = _launches(*counters)
    got = step_on(*batch)
    torch.cuda.synchronize()
    assert [n - b for n, b in zip(_launches(*counters), before)] == [4, 4, 8, 8]
    want = step_off(*batch)
    assert [n - b for n, b in zip(_launches(*counters), before)] == [4, 4, 8, 8]
    assert abs(got["loss"].item() - want["loss"].item()) <= 1e-2 * abs(want["loss"].item())
    g_on = global_norm([p.grad for p in on.parameters()]).item()
    g_off = global_norm([p.grad for p in off.parameters()]).item()
    assert abs(g_on - g_off) <= 5e-2 * g_off


def test_task_clis_run_on_the_card(cuda, tmp_path):
    """cli/pretrain and cli/classify (nlvr: 2 x B streams) --synthetic with
    the default --device cuda: finite losses, the model on the card."""
    import math

    from aladin_torch.cli import classify as classify_cli
    from aladin_torch.cli import pretrain as pretrain_cli

    dims = ["--max_seq_length", "24", "--max_img_seq_length", "8", "--img_feature_dim", "16",
            "--synthetic"]
    res = pretrain_cli.run(["--output_dir", str(tmp_path / "pt"), "--max_iters", "3",
                            "--train_batch_size", "4", *dims])
    assert next(res["model"].parameters()).is_cuda
    assert all(math.isfinite(v) for r in res["log"] for s in r["steps"] for v in s.values())
    res = classify_cli.run(["--task", "nlvr", "--output_dir", str(tmp_path / "cl"), "--epochs",
                            "1", "--train_batch_size", "8", "--do_test", *dims])
    assert next(res["model"].parameters()).is_cuda
    assert all(math.isfinite(v) for v in res["losses"]) and len(res["losses"]) == 4


def _kimi_two_layers(vocab=1024):
    """Kimi-VL's language model at the published widths, cut to its dense
    layer 0 and one MoE layer with all 64 experts (and a small vocabulary:
    the test reads the residual, not the head), bf16 on the card; the
    published-name weights in float32 (normal(0, 0.02) matrices, a
    correction bias normal(0, 0.02), unit norms)."""
    from aladin_torch.models import kimi_vl as K
    from h100_bench.reference import kimi_vl as ref

    c = dict(dataclasses.asdict(K.KimiVLConfig()), num_hidden_layers=2, vocab_size=vocab)
    gen = torch.Generator(device="cuda").manual_seed(11)
    w = {}
    for name, shape in ref.spec(c):
        if len(shape) >= 2 or name.endswith("correction_bias"):
            w[name] = (0.02 * torch.randn(shape, generator=gen, device="cuda")).bfloat16().float()
        else:
            w[name] = torch.ones(shape, device="cuda")
    with torch.device("meta"):
        model = K.KimiVLForCausalLM(K.KimiVLConfig.from_dict(c))
    model.to_empty(device="cuda")
    K.load_published(model, w.items())
    return model.eval(), w, c


def test_kimi_layers_at_published_widths_match_the_reference(cuda):
    """The dense layer 0 and layer 1's 64-expert MoE at the published
    widths, bf16 program against the float32 reference, each from the same
    bf16 input (300 tokens): the routing is the reference's on >= 99% of the
    tokens (the router runs in float32 on both sides, so only a tie in the
    last bits can differ), and the outputs lie within 1% of the reference's
    norm (bf16 rounds each product's operands to 2^-9; observed below)."""
    from aladin_torch.ops import moe
    from h100_bench.reference import kimi_vl as ref

    model, w, c = _kimi_two_layers()
    x = (0.02 * torch.randn(1, 300, 2048, generator=cuda, device="cuda")).bfloat16()
    ones = torch.ones(1, 300, dtype=torch.long, device="cuda")
    f32 = ref.Precision("f32")
    with torch.no_grad():
        got = model.layers[0](x, model.rope(model.positions(ones)), model.causal_mask(ones))[0]
        want = ref.layer(w, 0, c, x[0].float(), f32)[0]
        err_dense = float((got[0].float() - want).norm() / want.norm())
        layer = model.layers[1]
        h = layer.post_attention_layernorm(x)
        got = layer.mlp(h)[0]
        want, chosen = ref.moe(w, "language_model.model.layers.1.", c, h[0].float(), f32)
        mine = moe.route(h[0], layer.mlp.gate.weight, layer.mlp.gate.e_score_correction_bias,
                         6, c["routed_scaling_factor"])[1]
        same = (mine.sort(dim=1).values == chosen.sort(dim=1).values).all(dim=1)
        err_moe = float((got[same].float() - want[same]).norm() / want[same].norm())
    print(f"dense layer {err_dense:.3e}, MoE {err_moe:.3e}, routing agrees on "
          f"{float(same.float().mean()):.4f}")
    assert float(same.float().mean()) >= 0.99
    assert err_dense < 1e-2 and err_moe < 1e-2


def test_kimi_decode_step_never_syncs_with_the_host(cuda):
    """A cached decode step of the latent decoder (MLA absorbed, the MoE's
    sort, grouped GEMMs and combine, the head) runs under
    ``set_sync_debug_mode("error")``: nothing in it waits for the card."""
    from aladin_torch.tasks import decode_latent

    model, _, _ = _kimi_two_layers()
    b, p = 16, 40
    ids = torch.randint(0, 1000, (b, p), generator=cuda, device="cuda")
    mask = (torch.arange(p, device="cuda")[None, :] >= torch.arange(b, device="cuda")[:, None])
    with torch.no_grad():
        cache, logits = decode_latent.prefill(model, ids, None, mask.long(), 8)
        tok = logits.argmax(dim=-1)
        hits = torch.zeros((), dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for j in range(3):
                tok = decode_latent.decode_step(model, cache, tok, j, hits).argmax(dim=-1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert 0 < int(hits) <= 3 * 64


def test_kimi_step_graphs_equal_the_eager_steps(cuda):
    """``greedy_decode`` on the card replays one CUDA graph a key count;
    its tokens and log-probabilities are the eager steps' (the same kernels
    on the same buffers), and it counts the experts hit on the card."""
    from aladin_torch.tasks import decode_latent as DL

    model, _, _ = _kimi_two_layers()
    b, p, n = 16, 40, 24
    ids = torch.randint(0, 1000, (b, p), generator=cuda, device="cuda")
    mask = (torch.arange(p, device="cuda")[None, :] >= torch.arange(b, device="cuda")[:, None])
    mask = mask.long()
    with torch.no_grad():
        state = DL.GreedyState(model, b, p, n, "cuda")
        cache, logits = DL.prefill(model, ids, None, mask, n, latent=state.cache.latent)
        state.start(cache, logits)
        for j in range(n - 1):
            state.j.fill_(j)
            state.step(model, j)
        want = state.tokens.clone(), state.logprob.clone(), int(state.hits)
        got = DL.greedy_decode(model, ids, None, mask, max_steps=n)
        again = DL.greedy_decode(model, ids, None, mask, max_steps=n)
    key, graphs = model._step_graphs
    assert key == (b, p, n)
    assert len(graphs.graphs) == len({DL.step_keys(graphs.state.cache, j) for j in range(n - 1)})
    assert torch.equal(got[0], want[0]) and torch.equal(again[0], want[0])
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    assert int(graphs.state.hits) == want[2]


def test_kimi_step_graphs_hold_one_batch_shape(cuda):
    """A model keeps the step graphs of one batch shape: a batch of another
    prompt width frees the first set (its latent buffer and graph pool)
    before capturing its own, so width after width holds the memory of one
    set, and a width decoded again gives the tokens it gave before."""
    from aladin_torch.tasks import decode_latent as DL

    model, _, _ = _kimi_two_layers()
    b, n = 16, 24

    def batch(p):
        ids = torch.randint(0, 1000, (b, p), generator=cuda, device="cuda")
        mask = torch.arange(p, device="cuda")[None, :] >= torch.arange(b, device="cuda")[:, None]
        return ids, None, mask.long()

    narrow, wide = batch(40), batch(72)
    with torch.no_grad():
        first = DL.greedy_decode(model, *narrow, max_steps=n)
        torch.cuda.synchronize()
        one_set = torch.cuda.memory_allocated()
        DL.greedy_decode(model, *wide, max_steps=n)
        again = DL.greedy_decode(model, *narrow, max_steps=n)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    wide_latent = 2 * b * DL.cache_slots(72, n) * 576 * 2  # bytes of the wide set's buffer
    assert model._step_graphs[0] == (b, 40, n)
    assert torch.equal(again[0], first[0])
    # the outputs of the second decode are a few KB; a kept wide set would add its buffer
    assert after - one_set < wide_latent // 2, (one_set, after, wide_latent)


def _kda_raw(gen, lengths, h=32, d=128):
    """Raw KDA inputs at the published widths for documents packed end to
    end: q, k, v, f (N, h x d) and b (N, h) in bf16 (projections of unit
    rows through normal(0, 0.02) matrices of width 2304: ~0.96 rms; f as
    the low-rank decay projection, ~0.4), and the layer's per-channel
    weights as the benchmark draws them."""
    from aladin_torch.ops.kernels import kda

    n = sum(lengths)
    q, k, v = (torch.randn(n, h * d, generator=gen, device="cuda").bfloat16() for _ in range(3))
    f = (0.4 * torch.randn(n, h * d, generator=gen, device="cuda")).bfloat16()
    b = torch.randn(n, h, generator=gen, device="cuda").bfloat16()
    conv = (torch.rand(3, h * d, 4, generator=gen, device="cuda") - 0.5).bfloat16()
    a_log = torch.log(1 + 15 * torch.rand(h, generator=gen, device="cuda"))
    dt = torch.exp(math.log(1e-3) + torch.rand(h * d, generator=gen, device="cuda")
                   * math.log(100.0))
    return q, k, v, f, b, kda.Weights(conv, a_log, dt + torch.log(-torch.expm1(-dt)))


def _kda_ref_features(q, k, v, f, b, w, d=128, window=None):
    """The reference's KDA inputs in float32 from raw projections (one
    document): ``reference/kimi_linear.py``'s convolution, norms, decay and
    beta, the convolution started from ``window`` (3, 3D) if given."""
    from h100_bench.reference import kimi_linear as ref

    t, width = q.shape
    h = width // d
    feats = []
    for i, x in enumerate((q, k, v)):
        x = x.float()
        if window is not None:
            x = torch.cat([window[:, i * width:(i + 1) * width].float(), x])
        feats.append(ref.short_conv(x, w.conv[i].float())[-t:].reshape(t, h, d))
    qf, kf, vf = feats
    qf = qf * torch.rsqrt(qf.pow(2).sum(-1, keepdim=True) + 1e-6) / math.sqrt(d)
    kf = kf * torch.rsqrt(kf.pow(2).sum(-1, keepdim=True) + 1e-6)
    g = (-torch.exp(w.a_log)[:, None]
         * torch.nn.functional.softplus(f.float() + w.dt_bias).reshape(t, h, d))
    return qf, kf, vf, g, torch.sigmoid(b.float())


def test_k5_kda_prefill_matches_the_chunked_reference(cuda):
    """K5 at the published widths (32 heads of 128) on a packed batch that
    holds a 16,384-token document: each document's output and final state
    against ``reference/kimi_linear.py::kda_chunked`` on the same raw
    inputs, and the tails equal to each document's last 3 raw rows. The
    output is bf16 (2^-9 relative a value: 1e-2 on the norm leaves room);
    the state float32 on both sides, summed in other orders (observed
    below)."""
    from aladin_torch.ops.kernels import kda
    from h100_bench.reference import kimi_linear as ref

    lengths = [700, 16384, 2, 1500]
    q, k, v, f, b, w = _kda_raw(cuda, lengths)
    cu = torch.tensor([0] + list(itertools.accumulate(lengths)), dtype=torch.int32,
                      device="cuda")
    rows = torch.tensor([2, 0, 3, 1], device="cuda")
    state = torch.full((4, 32, 128, 128), float("nan"), device="cuda")
    tails = torch.zeros(4, 3, 3 * 4096, dtype=torch.bfloat16, device="cuda")
    (launches,) = _launches("k5.launches")
    o = kda.kda_prefill(q, k, v, f, b, w, cu, rows, state, tails)
    torch.cuda.synchronize()
    assert _launches("k5.launches")[0] == launches + 1
    worst_o = worst_s = 0.0
    with torch.no_grad():
        for d, row in enumerate(rows.tolist()):
            s = slice(int(cu[d]), int(cu[d + 1]))
            feats = _kda_ref_features(q[s], k[s], v[s], f[s], b[s], w)
            want_o, want_s = ref.kda_chunked(*(x[None] for x in feats))
            got_o = o[s].float().reshape(want_o.shape[1:])
            worst_o = max(worst_o, float((got_o - want_o[0]).norm() / want_o.norm()))
            got_s = state[row].transpose(-1, -2)  # the cache holds S transposed
            worst_s = max(worst_s, float((got_s - want_s[0]).norm() / want_s.norm()))
            raw = torch.cat([q[s], k[s], v[s]], dim=1)
            last = torch.cat([raw.new_zeros(3, raw.shape[1]), raw])[-3:]
            assert torch.equal(tails[row], last)
    print(f"K5 against kda_chunked: o {worst_o:.3e}, state {worst_s:.3e}")
    assert worst_o < 1e-2 and worst_s < 1e-3


def test_k6_kda_step_matches_the_recurrence(cuda):
    """K6 at the published widths, batch 64, three steps from a state and
    tails that K5 left: outputs, states and tails against
    ``reference/kimi_linear.py::kda_recurrent`` on the same raw inputs."""
    from aladin_torch.ops.kernels import kda
    from h100_bench.reference import kimi_linear as ref

    bsz, steps = 64, 3
    lengths = [int(x) for x in torch.randint(3, 40, (bsz,), generator=cuda,
                                             device="cuda").tolist()]
    q, k, v, f, b, w = _kda_raw(cuda, lengths)
    cu = torch.tensor([0] + list(itertools.accumulate(lengths)), dtype=torch.int32,
                      device="cuda")
    rows = torch.arange(bsz, device="cuda")
    state = torch.empty(bsz, 32, 128, 128, device="cuda")
    tails = torch.empty(bsz, 3, 3 * 4096, dtype=torch.bfloat16, device="cuda")
    kda.kda_prefill(q, k, v, f, b, w, cu, rows, state, tails)
    want_s, window = state.transpose(-1, -2).clone(), tails.clone()  # S, not S transposed
    worst_o = worst_s = 0.0
    for _ in range(steps):
        q1, k1, v1, f1, b1, _ = _kda_raw(cuda, [bsz])
        o = kda.kda_step(q1, k1, v1, f1, b1, w, state, tails)
        torch.cuda.synchronize()
        for r in range(bsz):
            feats = _kda_ref_features(q1[r:r + 1], k1[r:r + 1], v1[r:r + 1], f1[r:r + 1],
                                      b1[r:r + 1], w, window=window[r])
            want_o, s_r = ref.kda_recurrent(*(x[None] for x in feats), state=want_s[r:r + 1])
            want_s[r] = s_r[0]
            worst_o = max(worst_o, float((o[r].float() - want_o.flatten()).norm()
                                         / want_o.norm()))
        raw = torch.cat([q1, k1, v1], dim=1)
        window = torch.cat([window[:, 1:], raw[:, None]], dim=1)
        assert torch.equal(tails, window)
        got_s = state.transpose(-1, -2)
        worst_s = max(worst_s, float((got_s - want_s).norm() / want_s.norm()))
    print(f"K6 against kda_recurrent: o {worst_o:.3e}, state {worst_s:.3e}")
    assert worst_o < 1e-2 and worst_s < 1e-4


def test_held_expert_moe_at_published_widths(cuda):
    """``moe_forward`` holding experts 64-127 of a 256-output router, 2304
    x 1024, top-8, bf16: the held pairs (and only those) computed, against
    a float32 loop over the held experts on the same picks (the router is
    float32 on both sides); the pairs counted on the card."""
    from aladin_torch.ops import moe

    t, hid, width, first, held = 1024, 2304, 1024, 64, 64
    h = (torch.randn(t, hid, generator=cuda, device="cuda")).bfloat16()
    gw = 0.02 * torch.randn(256, hid, generator=cuda, device="cuda")
    bias = 0.02 * torch.randn(256, generator=cuda, device="cuda")
    gate_up = (0.02 * torch.randn(held, 2 * width, hid, generator=cuda, device="cuda")).bfloat16()
    down = (0.02 * torch.randn(held, hid, width, generator=cuda, device="cuda")).bfloat16()
    pairs = torch.zeros((), dtype=torch.int64, device="cuda")
    with torch.no_grad():
        got = moe.moe_forward(h, gw, bias, gate_up, down, top_k=8, scale=2.446, first=first,
                              pairs=pairs)
        w, picked = moe.route(h, gw, bias, 8, 2.446)
        want = torch.zeros(t, hid, device="cuda")
        for e in range(held):
            tok, slot = (picked == first + e).nonzero(as_tuple=True)
            gu = h[tok].float() @ gate_up[e].float().t()
            y = (torch.nn.functional.silu(gu[:, :width]) * gu[:, width:]) @ down[e].float().t()
            want.index_add_(0, tok, w[tok, slot, None] * y)
    inside = ((picked >= first) & (picked < first + held)).sum()
    err = float((got.float() - want).norm() / want.norm())
    print(f"held MoE: {int(inside)} of {t * 8} pairs held, error {err:.3e}")
    assert int(pairs) == int(inside) and 0 < int(inside) < t * 8
    assert err < 1e-2


def _kimi_linear_cut(vocab=1024):
    """Kimi-Linear at the published widths, cut to layers K K K M (layer 0
    dense) with 64 of 256 experts held and a small vocabulary, bf16 on the
    card, weights as the benchmark draws their kinds."""
    from aladin_torch.models import kimi_linear as KL
    from h100_bench.reference import kimi_linear as ref

    c = dict(dataclasses.asdict(KL.KimiLinearConfig()), num_hidden_layers=4, vocab_size=vocab,
             num_experts=64, router_experts=256,
             linear_attn_config={"full_attn_layers": [4], "kda_layers": [1, 2, 3],
                                 "head_dim": 128, "num_heads": 32, "short_conv_kernel_size": 4})
    gen = torch.Generator(device="cuda").manual_seed(12)
    w = {}
    for name, shape in ref.spec(c):
        if name.endswith("A_log"):
            w[name] = torch.log(1 + 15 * torch.rand(shape, generator=gen, device="cuda"))
        elif name.endswith("dt_bias"):
            dt = torch.exp(math.log(1e-3) + torch.rand(shape, generator=gen, device="cuda")
                           * math.log(100.0))
            w[name] = dt + torch.log(-torch.expm1(-dt))
        elif "_conv1d." in name:
            w[name] = torch.rand(shape, generator=gen, device="cuda") - 0.5
        elif name.endswith("g_b_proj.bias"):
            w[name] = torch.zeros(shape, device="cuda")
        elif len(shape) >= 2 or name.endswith("correction_bias"):
            w[name] = 0.02 * torch.randn(shape, generator=gen, device="cuda")
        else:
            w[name] = torch.ones(shape, device="cuda")
    with torch.device("meta"):
        model = KL.KimiLinearForCausalLM(KL.KimiLinearConfig.from_dict(c))
    model.to_empty(device="cuda")
    KL.load_named(model, w.items())
    return model.eval()


def test_kimi_linear_decode_step_never_syncs_with_the_host(cuda):
    """A hybrid decode step (K6 and the KDA output stage, the NoPE MLA
    absorbed over the latent rows, the held-expert MoE, the head) runs
    under ``set_sync_debug_mode("error")``: nothing in it waits for the
    card."""
    from aladin_torch.tasks import decode_hybrid as DH

    model = _kimi_linear_cut()
    lengths = [40, 7, 65, 23, 51, 12, 33, 64]
    ids = torch.randint(0, 1000, (sum(lengths),), generator=cuda, device="cuda")
    with torch.no_grad():
        state = DH.HybridState(model, len(lengths), max(lengths), 8, "cuda")
        tok = DH.prefill(model, ids, lengths, state).argmax(dim=-1)
        state.start(state.cache, torch.zeros(len(lengths), 1024, device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for j in range(3):
                tok = DH.decode_step(model, state, tok, j, state.hits, None,
                                     state.pairs).argmax(dim=-1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert 0 < int(state.hits) <= 3 * 64 and int(state.pairs) > 0
    assert bool(torch.isfinite(state.kda).all())


def test_kimi_linear_step_graphs_equal_the_eager_steps(cuda):
    """``greedy_decode`` on the card replays one CUDA graph a key count over
    the hybrid state; its tokens and log-probabilities are the eager
    steps', and a second batch of the same shape reuses the graphs and
    gives the same tokens (the prefill rewrites every state and tail)."""
    from aladin_torch.tasks import decode_hybrid as DH
    from aladin_torch.tasks import decode_latent as DL

    model = _kimi_linear_cut()
    lengths, n = [40, 7, 65, 23, 51, 12, 33, 64], 20
    ids = torch.randint(0, 1000, (sum(lengths),), generator=cuda, device="cuda")
    other = torch.randint(0, 1000, (sum(lengths),), generator=cuda, device="cuda")
    with torch.no_grad():
        state = DH.HybridState(model, len(lengths), max(lengths), n, "cuda")
        state.start(state.cache, DH.prefill(model, ids, lengths, state))
        for j in range(n - 1):
            state.j.fill_(j)
            state.step(model, j)
        want = state.tokens.clone(), state.logprob.clone()
        got = DH.greedy_decode(model, ids, lengths, max_steps=n)
        DH.greedy_decode(model, other, lengths, max_steps=n)
        again = DH.greedy_decode(model, ids, lengths, max_steps=n)
    key, graphs = model._step_graphs
    assert key == (len(lengths), max(lengths), n)
    assert len(graphs.graphs) == len({DL.step_keys(graphs.state.cache, j) for j in range(n - 1)})
    assert torch.equal(got[0], want[0]) and torch.equal(again[0], want[0])
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
