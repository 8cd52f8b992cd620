"""The port's losses (aladin_torch/ops/losses.py) and the chunked alignment
scorer against aladin_tpu's on the CPU.

Same numpy inputs through both packages, f32. Tolerance rtol 1e-5 /
atol 1e-5 on the values: the same f32 math summed in another order
(observed ~1e-7 relative); gradients (where the port's function is
differentiated) rtol 1e-4 for the same reason.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aladin_tpu.ops import losses as jl
from aladin_tpu.ops.alignment import alignment_scores_chunked as jax_chunked
from aladin_torch.ops import losses as tl
from aladin_torch.ops.alignment import alignment_scores, alignment_scores_chunked

RTOL, ATOL = 1e-5, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(rng, n=6, d=16):
    im = rng.randn(n, d).astype(np.float32)
    s = rng.randn(n, d).astype(np.float32)
    return im / np.linalg.norm(im, axis=1, keepdims=True), s / np.linalg.norm(s, axis=1,
                                                                               keepdims=True)


def _sets(rng, b=5, s_im=8, s_s=11, d=16):
    im = rng.randn(b, s_im, d).astype(np.float32)
    cap = rng.randn(b, s_s, d).astype(np.float32)
    il = rng.randint(2, s_im + 1, b).astype(np.int32)
    cl = rng.randint(4, s_s + 1, b).astype(np.int32)
    return im, cap, il, cl


@pytest.mark.parametrize("max_violation", [True, False])
@pytest.mark.parametrize("measure", ["dot", "cosine", "order"])
def test_matching_loss(rng, measure, max_violation):
    im, s = _pair(rng)
    want_loss, want_scores = jl.matching_loss(jnp.asarray(im), jnp.asarray(s), 0.2, measure,
                                              max_violation)
    got_loss, got_scores = tl.matching_loss(_t(im), _t(s), 0.2, measure, max_violation)
    _close(got_scores, want_scores)
    _close(got_loss, want_loss)


@pytest.mark.parametrize("aggregation", ["MrSw", "symm", "scan-sentences"])
@pytest.mark.parametrize("chunk", [0, 2])
def test_alignment_contrastive_loss(rng, aggregation, chunk):
    im, cap, il, cl = _sets(rng)
    want_loss, want_scores = jl.alignment_contrastive_loss(
        *(jnp.asarray(a) for a in (im, cap, il, cl)), 0.2, True, aggregation, chunk=chunk)
    got_loss, got_scores = tl.alignment_contrastive_loss(
        *(_t(a) for a in (im, cap, il, cl)), 0.2, True, aggregation, chunk=chunk)
    _close(got_scores, want_scores)
    _close(got_loss, want_loss)


def test_chunked_scorer_gradients_match_dense_and_jax(rng):
    """Checkpointed chunks (a short last block) give the dense scores and
    gradients, and aladin_tpu's chunked scorer's."""
    im, cap, il, cl = _sets(rng, b=7)
    w = rng.randn(7, 7).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(jax_chunked(a, b, jnp.asarray(il), jnp.asarray(cl), "MrSw", 3) * w)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(im), jnp.asarray(cap))
    grads = {}
    for name, fn in (("chunked", lambda a, b: alignment_scores_chunked(a, b, _t(il), _t(cl),
                                                                      "MrSw", 3)),
                     ("dense", lambda a, b: alignment_scores(a, b, _t(il), _t(cl), "MrSw"))):
        a, b = _t(im).requires_grad_(), _t(cap).requires_grad_()
        (fn(a, b) * _t(w)).sum().backward()
        grads[name] = (a.grad, b.grad)
    for name in grads:
        for g, wg in zip(grads[name], want):
            _close(g, wg, rtol=1e-4)


@pytest.mark.parametrize("mode", ["listnet", "mse", "ordinal", "contrastive"])
def test_distillation_loss(rng, mode):
    teacher = rng.rand(6, 6).astype(np.float32)
    student = rng.randn(6, 6).astype(np.float32)
    wb = np.asarray([0.7, -0.2], np.float32)
    want = jl.distillation_loss(jnp.asarray(teacher), jnp.asarray(student), mode,
                                wb=jnp.asarray(wb), margin=0.2)
    got = tl.distillation_loss(_t(teacher), _t(student), mode, wb=_t(wb), margin=0.2)
    _close(got, want)


def test_distillation_gradients(rng):
    """The teacher gets no gradient; the student's and wb's match JAX."""
    teacher = rng.rand(5, 5).astype(np.float32)
    student = rng.randn(5, 5).astype(np.float32)
    wb = np.asarray([0.5, 0.5], np.float32)
    for mode in ("listnet", "mse"):
        want = jax.grad(lambda t, s, w: jl.distillation_loss(t, s, mode, wb=w),
                        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (teacher, student, wb)))
        t, s, w = (_t(a).requires_grad_() for a in (teacher, student, wb))
        tl.distillation_loss(t, s, mode, wb=w).backward()
        assert t.grad is None or float(t.grad.abs().max()) == 0.0
        _close(s.grad, want[1], rtol=1e-4)
        if mode == "mse":
            _close(w.grad, want[2], rtol=1e-4)


def test_attention_distillation_loss(rng):
    im, cap, il, cl = _sets(rng)
    teacher = rng.rand(5, 5, 12, 9).astype(np.float32)
    teacher[teacher < 0.2] = 0.0
    want = jl.attention_distillation_loss(*(jnp.asarray(a) for a in (im, cap, il, cl, teacher)))
    got = tl.attention_distillation_loss(*(_t(a) for a in (im, cap, il, cl, teacher)))
    _close(got, want)


def test_entropy_and_l1_terms(rng):
    im, s = _pair(rng, n=7)
    _close(tl.entropy_uniformity_loss(_t(im), _t(s)),
           jl.entropy_uniformity_loss(jnp.asarray(im), jnp.asarray(s)))
    hi = rng.randn(3, 4, 5, 8).astype(np.float32)
    ht = rng.randn(3, 4, 6, 8).astype(np.float32)
    _close(tl.l1_hidden_regularization(_t(hi), _t(ht)),
           jl.l1_hidden_regularization(jnp.asarray(hi), jnp.asarray(ht)))


def test_info_nce_and_perm_inv(rng):
    im, s = _pair(rng, n=6)
    lt = np.asarray(np.log(1 / 0.07), np.float32)
    _close(tl.info_nce_loss(_t(im), _t(s), _t(lt)),
           jl.info_nce_loss(jnp.asarray(im), jnp.asarray(s), jnp.asarray(lt)))
    a = rng.randn(4, 5, 8).astype(np.float32)
    b = rng.randn(4, 6, 8).astype(np.float32)
    _close(tl.perm_inv_matching_loss(_t(a), _t(b)),
           jl.perm_inv_matching_loss(jnp.asarray(a), jnp.asarray(b)))


def test_semantic_contrastive_loss(rng):
    """With every off-diagonal relevance below the threshold the random
    positive is the diagonal in both packages (the draws differ, the picks
    cannot), so the two agree and equal the plain hinge."""
    im, s = _pair(rng, n=6)
    rel = rng.rand(6, 6).astype(np.float32) * 0.3
    want = jl.semantic_contrastive_loss(jnp.asarray(im), jnp.asarray(s), jnp.asarray(rel),
                                        jax.random.PRNGKey(0), threshold=0.4)
    got = tl.semantic_contrastive_loss(_t(im), _t(s), _t(rel),
                                       torch.Generator().manual_seed(0), threshold=0.4)
    _close(got, want)
    _close(got, jl.contrastive_hinge(jnp.asarray(im @ s.T), 0.2, True))


@pytest.mark.parametrize("auto", [False, True])
def test_combine_losses(rng, auto):
    terms = {"alignment": np.float32(1.7), "matching": np.float32(0.4)}
    weights = {"alignment": 1.0, "matching": 0.5}
    aw = {"alignment": np.asarray([-2.3], np.float32), "matching": np.asarray([0.1], np.float32)}
    want = jl.combine_losses({k: jnp.asarray(v) for k, v in terms.items()}, weights,
                             {k: jnp.asarray(v) for k, v in aw.items()} if auto else None)
    got = tl.combine_losses({k: torch.tensor(v) for k, v in terms.items()}, weights,
                            {k: _t(v) for k, v in aw.items()} if auto else None)
    _close(got, want)
