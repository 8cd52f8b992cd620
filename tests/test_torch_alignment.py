"""The port's alignment ops and MrSw scorer against aladin_tpu on the CPU.

Same numpy inputs through both packages, f32. aladin_tpu's Pallas kernel
runs in interpret mode; the port's ``mrsw_scores`` takes its plain version
for CPU tensors. The CUDA kernel itself is held to the plain version on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("bucket_images", [False, True])
def test_bucketed_equals_unbucketed_f32(rng, bucket_images):
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
    got = tak.mrsw_scores_bucketed(*args, compute_dtype=torch.float32,
                                   bucket_images=bucket_images, image_bucket_multiple=4).numpy()
    np.testing.assert_allclose(got, full, atol=1e-6)
    want = np.asarray(jax_bucketed(*_jax(im, ss, il, sl), interpret=True,
                                   compute_dtype=jnp.float32, bucket_images=bucket_images,
                                   image_bucket_multiple=4))
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
    before = tak.mrsw_scores.launches
    tak.mrsw_scores(*case, compute_dtype=torch.bfloat16)
    tak.mrsw_scores(*case, compute_dtype=torch.int8)
    assert tak.mrsw_scores.launches == before
    with pytest.raises(ValueError):
        tak.mrsw_scores(*case, compute_dtype=torch.float16)
