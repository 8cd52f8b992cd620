"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA device and nvcc:

    python -m pytest tests/test_torch_gpu.py -m gpu

Without a card every test skips (the kernels have no CPU mode); the CPU
parity of the plain versions with aladin_tpu is in tests/test_torch_*.py.
"""

import pytest
import torch

from aladin_torch.ops.kernels import alignment_kernel as ak

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MrSw kernel runs only on the card")
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
