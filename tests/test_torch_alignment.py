"""The port's alignment ops and MrSw scorer against aladin_tpu on the CPU.

Same numpy inputs through both packages, f32. aladin_tpu's Pallas kernel
runs in interpret mode; the port's ``mrsw_scores`` takes its plain version
for CPU tensors. The CUDA kernel itself is held to the plain version on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from aladin_tpu.ops import alignment as jal
from aladin_tpu.ops import masking as jmask
from aladin_tpu.ops import similarity as jsim
from aladin_tpu.ops.pallas.alignment_kernel import mrsw_scores_bucketed as jax_bucketed
from aladin_tpu.ops.pallas.alignment_kernel import mrsw_scores_pallas
from aladin_torch.ops import alignment as tal
from aladin_torch.ops import masking as tmask
from aladin_torch.ops import similarity as tsim
from aladin_torch.ops.kernels import alignment_kernel as tak
from aladin_torch.utils import profiling


def _floor_case(rng, n_im=10, n_cap=23, s_im=12, s_s=14, d=32):
    """Random sets with the zero-floor trap built in: image 0 fills its
    buffer (no zero rows, no floor), image 1 is short (floored at 0), and
    word 1 of caption 0 points against every real region of both, so all
    its real alignments with them are negative."""
    im = rng.randn(n_im, s_im, d).astype(np.float32)
    ss = rng.randn(n_cap, s_s, d).astype(np.float32)
    il = rng.randint(2, s_im + 1, n_im).astype(np.int32)
    sl = rng.randint(4, s_s + 1, n_cap).astype(np.int32)
    il[0], il[1] = s_im, 5
    ss[0, 1] = -(im[0, 1:].sum(0) + im[1, 1:5].sum(0))
    return im, ss, il, sl


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_floor_case_exercises_the_trap(rng):
    im, ss, _, _ = _floor_case(rng)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)  # noqa: E731
    word = unit(ss[0, 1])
    assert (unit(im[0, 1:]) @ word).max() < 0  # full buffer: the max is negative
    assert (unit(im[1, 1:5]) @ word).max() < 0  # short image: real values negative, floor 0


def test_mrsw_plain_matches_pallas_and_dense_f32(rng):
    """f32, atol 1e-4: both sides compute the same f32 dot products in
    another summation order (errors ~1e-6 at D=32)."""
    case = _floor_case(rng)
    want_kernel = np.asarray(mrsw_scores_pallas(*_jax(*case), interpret=True,
                                                compute_dtype=jnp.float32))
    want_dense = np.asarray(jal.alignment_scores(*_jax(*case), "MrSw"))
    got = tak.mrsw_scores(*_torch(*case), compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=1e-4)
    np.testing.assert_allclose(got, want_dense, atol=1e-4)
    np.testing.assert_allclose(tak.mrsw_scores_plain(*_torch(*case),
                                                     compute_dtype=torch.float32).numpy(),
                               want_kernel, atol=1e-4)


def test_mrsw_int8_matches_pallas(rng):
    """int8, atol 1e-5: the integer sums are exact on both sides and the
    per-tensor scales are computed the same way; only the f32 word sum
    and descale round."""
    case = _floor_case(rng)
    want = np.asarray(mrsw_scores_pallas(*_jax(*case), interpret=True, compute_dtype=jnp.int8))
    got = tak.mrsw_scores(*_torch(*case), compute_dtype=torch.int8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mrsw_bf16_plain_rounds_operands_like_pallas(rng):
    """bf16 operands with f32 accumulation, atol 1e-4: the operands round
    to the same bf16 values; the accumulation order differs."""
    case = _floor_case(rng)
    want = np.asarray(mrsw_scores_pallas(*_jax(*case), interpret=True,
                                         compute_dtype=jnp.bfloat16))
    got = tak.mrsw_scores(*_torch(*case), compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bucketed_equals_unbucketed_f32(rng):
    """Bucketing drops only zeroed slots, so f32 scores agree; atol 1e-6
    because the CPU matmul sums in a shape-dependent order (the kernel's
    bitwise shape independence is checked on the card)."""
    n_im, n_cap, r, w, d = 6, 37, 9, 50, 16
    im = rng.randn(n_im, r, d).astype(np.float32)
    ss = rng.randn(n_cap, w, d).astype(np.float32)
    il = rng.randint(2, r + 1, n_im).astype(np.int32)
    il[0] = r
    sl = np.concatenate([rng.randint(4, 18, n_cap - 3), [4, w, w]]).astype(np.int32)
    args = _torch(im, ss, il, sl)
    full = tak.mrsw_scores(*args, compute_dtype=torch.float32).numpy()
    got = tak.mrsw_scores_bucketed(*args, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, full, atol=1e-6)
    want = np.asarray(jax_bucketed(*_jax(im, ss, il, sl), interpret=True,
                                   compute_dtype=jnp.float32))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bucketed_int8_scales_per_bucket_like_jax(rng):
    """int8 bucketing: scales are per call, hence per bucket, in both
    packages; atol 1e-5 against aladin_tpu's bucketed int8."""
    im = rng.randn(5, 8, 16).astype(np.float32)
    ss = rng.randn(30, 50, 16).astype(np.float32)
    il = rng.randint(2, 9, 5).astype(np.int32)
    sl = rng.randint(4, 51, 30).astype(np.int32)
    want = np.asarray(jax_bucketed(*_jax(im, ss, il, sl), interpret=True,
                                   compute_dtype=jnp.int8))
    got = tak.mrsw_scores_bucketed(*_torch(im, ss, il, sl), compute_dtype=torch.int8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("aggregation", jal.AGGREGATIONS)
def test_alignment_scores_all_modes(rng, aggregation):
    """All 7 aggregations, f32, atol 1e-5 (same math, other sum order)."""
    case = _floor_case(rng, n_im=5, n_cap=7, s_im=9, s_s=11, d=16)
    want = np.asarray(jal.alignment_scores(*_jax(*case), aggregation))
    got = tal.alignment_scores(*_torch(*case), aggregation).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_score_all_pairs_blocks_match_dense(rng):
    """Blocked scoring (a short last block, no padding captions) equals the
    dense matrix and aladin_tpu's padded scan; atol 1e-5."""
    case = _floor_case(rng, n_im=4, n_cap=13, s_im=7, s_s=9, d=16)
    dense = tal.alignment_scores(*_torch(*case), "MrSw").numpy()
    got = tal.score_all_pairs(*_torch(*case), "MrSw", block_caps=5).numpy()
    np.testing.assert_allclose(got, dense, atol=1e-6)
    im, ss, il, sl = case
    ss_p = np.concatenate([ss, np.zeros((2, *ss.shape[1:]), np.float32)])
    sl_p = np.concatenate([sl, [4, 4]]).astype(np.int32)
    want = np.asarray(jal.score_all_pairs(*_jax(im, ss_p, il, sl_p), "MrSw", 5))[:, :13]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_masks_bias_and_l2norm(rng):
    lens = np.array([0, 3, 5], np.int32)
    np.testing.assert_array_equal(tmask.valid_mask(torch.from_numpy(lens), 5).numpy(),
                                  np.asarray(jmask.valid_mask(jnp.asarray(lens), 5)))
    np.testing.assert_array_equal(tmask.padding_mask(torch.from_numpy(lens), 5).numpy(),
                                  np.asarray(jmask.padding_mask(jnp.asarray(lens), 5)))
    for m in (rng.randint(0, 2, (2, 6)), rng.randint(0, 2, (2, 4, 6))):
        np.testing.assert_array_equal(
            tmask.additive_attention_bias(torch.from_numpy(m)).numpy(),
            np.asarray(jmask.additive_attention_bias(jnp.asarray(m))))
    with pytest.raises(ValueError):
        tmask.additive_attention_bias(torch.ones(3))
    x = rng.randn(4, 3, 8).astype(np.float32)
    x[0, 0] = 0.0  # a zero vector: eps clamps, bare division gives nan
    for eps in (0.0, 1e-12):
        np.testing.assert_allclose(tsim.l2norm(torch.from_numpy(x), eps=eps).numpy(),
                                   np.asarray(jsim.l2norm(jnp.asarray(x), eps=eps)),
                                   atol=1e-6, equal_nan=True)


def test_strip_special_tokens_shapes():
    im, ss = torch.zeros(2, 10, 4), torch.zeros(3, 12, 4)
    a, b, il, sl = tal.strip_special_tokens(im, ss, torch.tensor([10, 4]), torch.tensor([12, 6, 5]))
    assert a.shape == (2, 9, 4) and b.shape == (3, 9, 4)
    assert il.tolist() == [9, 3] and sl.tolist() == [9, 3, 2]


def test_cpu_scoring_launches_no_kernel(rng):
    """CPU tensors take the plain version and leave the launch count alone;
    an unknown dtype raises."""
    case = _torch(*_floor_case(rng, n_im=3, n_cap=4, s_im=6, s_s=7, d=8))
    before = profiling.counters()["k1.launches"]
    tak.mrsw_scores(*case, compute_dtype=torch.bfloat16)
    tak.mrsw_scores(*case, compute_dtype=torch.int8)
    assert profiling.counters()["k1.launches"] == before
    with pytest.raises(ValueError):
        tak.mrsw_scores(*case, compute_dtype=torch.float16)


# (n_im, n_cap, S_im, S_s) of the card tests (tests/test_torch_gpu.py), here at D 64
_KERNEL_SHAPES = [(7, 11, 5, 6), (37, 53, 34, 50), (5, 9, 129, 20), (9, 13, 2, 4),
                  (17, 29, 9, 19), (8, 33, 51, 16), (3, 5, 129, 131), (1001, 70, 34, 50)]


def _emulate_kernel(a, b, n_im, r, n_cap, w, pad_slot=float("-inf"), plan=None):
    """csrc/mrsw_kernel.cu's reduction on an operand layout: per group of 8
    images the max over its region slots (the slabs' and the tail's, as
    many as ``a`` holds), slots >= r set to ``pad_slot``; then
    each 16-word group of a caption's own words summed by a pairwise tree
    and its groups added in order. Products in f64: exact for int8 (summed
    in f64, exact, as the kernel's int32), rounded once to f32 for bf16 (so
    they do not depend on the layout) and summed in f32.

    ``plan`` None: ``b`` is the padded layout, each caption W16 rows (W
    padded with zero words to a multiple of 16). Else ``b`` is the packed
    operand and ``plan`` its tiles of 256 rows from each tile's first word
    row (rows past ``b`` read as zeros): a caption's words from its column,
    past its count 0."""
    red = torch.float64 if a.dtype == torch.int8 else torch.float32
    groups = -(-n_im // 8)
    slots = a.shape[0] // (8 * groups)  # the slots a group holds
    padded = (torch.arange(slots) >= r)[None, :, None, None]

    def col_max(rows):
        align = (a.double() @ rows.double().T).to(red)
        align = align.view(groups, slots, 8, -1).masked_fill(padded, pad_slot)
        return align.amax(dim=1).reshape(groups * 8, -1)[:n_im]

    def tree_sum(x):  # (..., groups of 16, 16)
        while x.shape[-1] > 1:
            x = x[..., 0::2] + x[..., 1::2]
        total = x[..., 0, 0]
        for g in range(1, x.shape[-2]):
            total = total + x[..., g, 0]
        return total.float()

    out = torch.empty(n_im, n_cap, dtype=torch.float32)
    if plan is None:
        w16 = -(-w // 16) * 16
        for c0 in range(0, n_cap, 16):
            blk = b[c0 * w16:(c0 + 16) * w16]
            nc = blk.shape[0] // w16
            out[:, c0:c0 + nc] = tree_sum(col_max(blk).view(n_im, nc, w16 // 16, 16))
        return out
    rows = torch.cat([b, b.new_zeros(plan.cols, b.shape[1])])
    for first, c0, count, _ in plan.tiles.tolist():
        m = col_max(rows[first:first + plan.cols])
        caps = plan.caps[c0:c0 + count]
        x = m.new_zeros(n_im, count, max(1, -(-int(caps[:, 1].max()) // 16)) * 16)
        for k, (col, n, _, _) in enumerate(caps.tolist()):
            x[:, k, :n] = m[:, col:col + n]
        out[:, torch.as_tensor(caps[:, 2].astype(np.int64))] = tree_sum(
            x.view(n_im, count, -1, 16))
    return out


def _padded_operand(cap):
    """The padded caption layout of ``_emulate_kernel``: (N_cap * W16, D
    padded to 128 bytes) from prepared (N_cap, W, D)."""
    n_cap, w, d = cap.shape
    d_pad = (-d) % (128 // cap.element_size())
    return F.pad(cap, (0, d_pad, 0, -w % 16)).reshape(-1, d + d_pad)


def _kernel_case(rng, n_im, n_cap, s_im, s_s, d=64):
    """Random sets at a card-test shape, with the zero-floor trap of
    ``_floor_case`` where the shape has room for it."""
    im = rng.randn(n_im, s_im, d).astype(np.float32)
    ss = rng.randn(n_cap, s_s, d).astype(np.float32)
    il = rng.randint(2, s_im + 1, n_im).astype(np.int32)
    sl = rng.randint(4, s_s + 1, n_cap).astype(np.int32) if s_s >= 4 else np.full(n_cap, s_s,
                                                                                 np.int32)
    if n_im >= 2 and s_im >= 3 and s_s >= 4:
        short = min(5, s_im - 1)
        il[0], il[1] = s_im, short
        ss[0, 1] = -(im[0, 1:].sum(0) + im[1, 1:short].sum(0))
    return _torch(im, ss, il, sl)


@pytest.mark.parametrize("layout", ["padded", "packed"])
@pytest.mark.parametrize("shape", _KERNEL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_kernel_layout_and_reduction_match_plain(rng, shape, dtype, layout):
    """_kernel_operands plus the kernel's reduction order, emulated in torch,
    equal _plain_core: int8 exactly (integer sums); bf16 to atol 1e-4 (the
    same bf16 products, f32 sums over D and words in another order, on
    scores of at most 128). The packed operand holds exactly the prepared
    valid words, and its walk equals the padded layout's bit for bit: each
    caption is summed by the same tree."""
    case = _kernel_case(rng, *shape)
    im, cap, _ = tak._prepare(*case, dtype)
    r, w = im.shape[1], cap.shape[1]
    d_pad = 128 // im.element_size()  # D 64 padded to 128 bytes
    a, _ = tak._kernel_operands(im, cap[0])
    assert a.shape == (-(-shape[0] // 8) * 8 * _slots(r), d_pad)
    padded = _emulate_kernel(a, _padded_operand(cap), shape[0], r, shape[1], w)
    want = tak._plain_core(im, cap)
    if layout == "packed":
        im_p, words, _, plan, _ = tak._packed(*case, dtype)
        assert torch.equal(im_p, im)
        caps = torch.as_tensor(plan.caps.astype(np.int64))
        cap_of = torch.repeat_interleave(caps[:, 2], caps[:, 1])
        pos = torch.arange(plan.n_words) - torch.repeat_interleave(caps[:, 3], caps[:, 1])
        assert torch.equal(words, cap[cap_of, pos])
        _, b = tak._kernel_operands(im_p, words)
        assert b.shape == (max(plan.n_words, 1), d_pad)
        got = _emulate_kernel(a, b, shape[0], r, shape[1], w, plan=plan)
        assert torch.equal(got, padded)
    else:
        got = padded
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _slots(r):
    """The slots an image holds in K1's operand: R rounded up to 8, or to 2
    where R mod 8 is 1 or 2 past the first 8 (the kernel's tail pass)."""
    return -(-r // 2) * 2 if r > 8 and r % 8 in (1, 2) else -(-r // 8) * 8


@pytest.mark.parametrize("r", [16, 33, 34, 35, 37])  # R mod 8: 0, 1, 2, 3, 5
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_kernel_operand_layout_by_r_mod_8(rng, r, dtype):
    """Row (g * slots + j) * 8 + s of the image operand is region j of image
    8g + s; slots j >= R and images past N_im are zero; a group holds 8
    floor(R / 8) + 2 slots for R mod 8 in {1, 2} (the tail) and R rounded
    up to 8 else. The emulated reduction on it equals the plain version."""
    case = _kernel_case(rng, 11, 7, r + 1, 20)
    im, cap, _ = tak._prepare(*case, dtype)
    a, _ = tak._kernel_operands(im, cap[0])
    slots = tak._group_slots(r)
    assert slots == _slots(r) and a.shape == (16 * slots, 128 // im.element_size())
    rows = a[:, :im.shape[2]].view(2, slots, 8, -1).transpose(1, 2).reshape(16, slots, -1)
    assert torch.equal(rows[:11, :r], im)
    assert not rows[:11, r:].any() and not rows[11:].any() and not a[:, im.shape[2]:].any()
    got = _emulate_kernel(a, _padded_operand(cap), 11, r, 7, cap.shape[1])
    want = tak._plain_core(im, cap)
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _tail_trap(rng, n_im=9, d=768):
    """R 33 sets (the score cell's), int8: image 0 fills its 33 slots, image
    2 has 32 regions, so its only zero slot inside R is slot 32, the tail's
    first; word 1 of caption 0 points against every real region of both."""
    im = rng.randn(n_im, 34, d).astype(np.float32)
    ss = rng.randn(5, 50, d).astype(np.float32)
    il = rng.randint(2, 35, n_im).astype(np.int32)
    sl = rng.randint(4, 51, 5).astype(np.int32)
    il[0], il[2] = 34, 33
    ss[0, 1] = -(im[0, 1:].sum(0) + im[2, 1:33].sum(0))
    im_p, cap, _ = tak._prepare(*_torch(im, ss, il, sl), torch.int8)
    a, _ = tak._kernel_operands(im_p, cap[0])
    return im_p, cap, a


def test_kernel_layout_excludes_padded_slots(rng):
    """The zero-floor trap at R 33 (D 768, where the trap word is negative
    against every real region): the tail layout pads one slot, 33; with it
    excluded the emulation equals the plain version; letting it join the
    max as the zero it holds floors image 0 and moves its score."""
    im, cap, a = _tail_trap(rng)
    assert a.shape[0] == 16 * 34
    args = (a, _padded_operand(cap), 9, im.shape[1], 5, cap.shape[1])
    want = tak._plain_core(im, cap)
    assert torch.equal(_emulate_kernel(*args), want)
    floored = _emulate_kernel(*args, pad_slot=0.0)
    assert floored[0, 0] > want[0, 0]


def test_kernel_layout_keeps_the_zero_floor_in_the_tail(rng):
    """Image 2 of the R 33 trap has 32 regions: its zero slot 32 lies in the
    tail rows and floors its max at 0, as in the plain version; a reduction
    that stopped at slot 32 would drop its score."""
    im, cap, a = _tail_trap(rng)
    want = tak._plain_core(im, cap)
    b = _padded_operand(cap)
    assert torch.equal(_emulate_kernel(a, b, 9, 33, 5, cap.shape[1]), want)
    assert _emulate_kernel(a, b, 9, 32, 5, cap.shape[1])[2, 0] < want[2, 0]


def _plan_counts(case):
    """Word counts of a planner case: random COCO-like and wide mixes, zeros
    among them, one caption, fewer captions than fill a tile."""
    rng = np.random.RandomState(len(case))
    if case == "coco":
        return np.clip(np.round(9 + rng.gamma(2.0, 2.5, 3000)), 8, 50).astype(int) - 3
    if case == "wide":
        return rng.randint(0, 129, 1000)
    if case == "with_zeros":
        return np.concatenate([rng.randint(0, 30, 400), np.zeros(300, int)])[rng.permutation(700)]
    if case == "zeros":
        return np.zeros(600, int)
    if case == "one":
        return np.array([37])
    return rng.randint(1, 20, 7)  # "short": not one full tile


@pytest.mark.parametrize("case", ["coco", "wide", "with_zeros", "zeros", "one", "short",
                                  "uniform"])
def test_plan_packs_whole_captions_in_length_order(case):
    """_plan: every caption lands in exactly one tile, whole, the captions
    in stable length order, no tile past 256 columns or 256 captions, and
    never more tiles than floor(256 / W16) whole captions a tile need (W16:
    the longest caption rounded up to 16); "uniform" checks every uniform
    length from 1 to 128 (100 captions each)."""
    mixes = ([np.full(100, n) for n in range(1, 129)] if case == "uniform"
             else [_plan_counts(case)])
    for counts in mixes:
        plan = tak._plan(counts)
        caps, tiles = plan.caps.astype(np.int64), plan.tiles.astype(np.int64)
        n = len(counts)
        assert plan.cols == 256 and plan.n_words == counts.sum()
        assert sorted(caps[:, 2]) == list(range(n))  # each caption once
        np.testing.assert_array_equal(caps[:, 1], counts[caps[:, 2]])
        key = caps[:, 1] * n + caps[:, 2]  # by count, then corpus order
        assert (np.diff(key) > 0).all()
        np.testing.assert_array_equal(caps[:, 3], np.concatenate([[0], np.cumsum(caps[:-1, 1])]))
        assert tiles[0, 1] == 0 and tiles[:, 2].sum() == n and (tiles[:, 2] >= 1).all()
        assert (tiles[:, 2] <= 256).all()
        np.testing.assert_array_equal(tiles[1:, 1], np.cumsum(tiles[:-1, 2]))
        for first, c0, count, _ in tiles:
            mine = caps[c0:c0 + count]
            assert first == mine[0, 3]
            np.testing.assert_array_equal(mine[:, 0], mine[:, 3] - first)  # whole, in order
            assert mine[-1, 0] + mine[-1, 1] <= 256
        w16 = -(-max(int(counts.max()), 1) // 16) * 16
        assert len(tiles) <= -(-n // (256 // w16))
