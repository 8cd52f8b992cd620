"""Two-stage search (aladin_torch/eval/search.py) and serial latency
(eval/latency.py) on the CPU: the contracts of tests/test_search.py without
the sharded cases, and the port against aladin_tpu on the same seeded
numpy corpus (indices equal, scores within 1e-4: the same f32 math summed
in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aladin_torch.eval import latency as tlat
from aladin_torch.eval import search as tsearch
from aladin_torch.eval.search import build_corpus, search
from aladin_torch.ops.alignment import alignment_scores
from aladin_tpu.eval import latency as jlat
from aladin_tpu.eval.search import build_corpus as jax_build_corpus
from aladin_tpu.eval.search import search as jax_search

TOL = 1e-4


def _fake_buffers(rng, n, s, d):
    """(N, S, D) encode-style buffers: unit-norm tokens, slot-0 global."""
    embs = rng.standard_normal((n, s, d)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    lens = rng.integers(5, s + 1, size=n).astype(np.int32)
    return embs, lens


@pytest.fixture(scope="module")
def corpus_data():
    rng = np.random.default_rng(0)
    img_embs, img_lens = _fake_buffers(rng, 24, 9, 16)  # images: 8 regions + slot 0
    cap_embs, cap_lens = _fake_buffers(rng, 60, 12, 16)  # captions
    return img_embs, img_lens, cap_embs, cap_lens


def _full_alignment(img_embs, img_lens, cap_embs, cap_lens):
    return alignment_scores(torch.from_numpy(img_embs), torch.from_numpy(cap_embs),
                            torch.from_numpy(img_lens), torch.from_numpy(cap_lens),
                            "MrSw").numpy()


def _corpus(embs, lens, **kw):
    return build_corpus(embs, lens, device="cpu", **kw)


def _stable_desc(x, k):
    return np.argsort(-x, axis=1, kind="stable")[:, :k]


def test_matching_only_equals_bruteforce(corpus_data):
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    scores, idx = search(_corpus(cap_embs, cap_lens), img_embs, img_lens, direction="i2t", k=7,
                         rerank=False)
    full = img_embs[:, 0] @ cap_embs[:, 0].T
    want = _stable_desc(full, 7)
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_allclose(scores, np.take_along_axis(full, want, axis=1), rtol=0, atol=2e-3)
    assert scores.dtype == np.float32 and idx.dtype == np.int32


def test_two_stage_exact_when_shortlist_covers_corpus(corpus_data):
    """Exact at a matched dtype (f32 store), both directions."""
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    full = _full_alignment(img_embs, img_lens, cap_embs, cap_lens)

    cap_corpus = _corpus(cap_embs, cap_lens, store_dtype=torch.float32)
    scores, idx = search(cap_corpus, img_embs, img_lens, direction="i2t", k=5,
                         shortlist=10_000, rerank=True)
    want = _stable_desc(full, 5)
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_allclose(scores, np.take_along_axis(full, want, axis=1), atol=TOL)

    img_corpus = _corpus(img_embs, img_lens, store_dtype=torch.float32)
    _, idx_t = search(img_corpus, cap_embs, cap_lens, direction="t2i", k=5, shortlist=10_000,
                      rerank=True)
    np.testing.assert_array_equal(idx_t, _stable_desc(full.T, 5))


def test_shortlist_bounds_rerank_candidates(corpus_data):
    """At shortlist K every returned index comes from stage 1's top K."""
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    _, idx = search(_corpus(cap_embs, cap_lens), img_embs, img_lens, direction="i2t", k=5,
                    shortlist=8, rerank=True)
    stage1 = _stable_desc(img_embs[:, 0] @ cap_embs[:, 0].T, 8)
    for q in range(idx.shape[0]):
        assert set(idx[q]) <= set(stage1[q])


def test_query_chunking_is_invisible(corpus_data):
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    corpus = _corpus(cap_embs, cap_lens)
    kw = dict(direction="i2t", k=4, shortlist=12, rerank=True)
    s1, i1 = search(corpus, img_embs, img_lens, query_chunk=None, **kw)
    s2, i2 = search(corpus, img_embs, img_lens, query_chunk=7, **kw)  # ragged tail
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-5)


@pytest.mark.parametrize("direction", ["i2t", "t2i"])
def test_rerank_blocking_is_invisible(corpus_data, monkeypatch, direction):
    """The rerank scores the shortlist in blocks of RERANK_BLOCK candidates
    (ragged here: 5 + 5 + 2); the results equal one block's."""
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    if direction == "i2t":
        corpus, q, ql = _corpus(cap_embs, cap_lens), img_embs, img_lens
    else:
        corpus, q, ql = _corpus(img_embs, img_lens), cap_embs, cap_lens
    kw = dict(direction=direction, k=4, shortlist=12, rerank=True)
    s1, i1 = search(corpus, q, ql, **kw)
    monkeypatch.setattr(tsearch, "RERANK_BLOCK", 5)
    s2, i2 = search(corpus, q, ql, **kw)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-5)


def test_bad_direction_raises(corpus_data):
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    with pytest.raises(ValueError):
        search(_corpus(cap_embs, cap_lens), img_embs, img_lens, direction="sideways")


def test_bf16_store_rank_parity(corpus_data):
    """The default bf16 store against the f32 full-alignment ranking: top-1
    for >= 90% of queries, top-5 overlap >= 4 on average, scores within
    5e-2 (tests/test_search.py's accuracy lock)."""
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    full = _full_alignment(img_embs, img_lens, cap_embs, cap_lens)
    scores, idx = search(_corpus(cap_embs, cap_lens), img_embs, img_lens, direction="i2t", k=5,
                         shortlist=10_000, rerank=True)
    want = _stable_desc(full, 5)
    assert (idx[:, 0] == want[:, 0]).mean() >= 0.9
    assert np.mean([len(set(idx[q]) & set(want[q])) for q in range(len(idx))]) >= 4.0
    np.testing.assert_allclose(scores, np.take_along_axis(full, idx, axis=1), atol=5e-2)


@pytest.mark.parametrize("rerank", [False, True])
def test_empty_query_set_returns_empty(corpus_data, rerank):
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    s, i = search(_corpus(cap_embs, cap_lens), img_embs[:0], img_lens[:0], direction="i2t", k=5,
                  shortlist=3, rerank=rerank)
    assert s.shape == i.shape == (0, 3 if rerank else 5)


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("direction", ["i2t", "t2i"])
def test_search_matches_jax(corpus_data, direction, rerank, store):
    """The port's search against aladin_tpu's on one corpus: indices equal,
    scores within 1e-4."""
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    if direction == "i2t":
        c, cl, q, ql = cap_embs, cap_lens, img_embs, img_lens
    else:
        c, cl, q, ql = img_embs, img_lens, cap_embs, cap_lens
    kw = dict(direction=direction, k=6, shortlist=10, rerank=rerank, query_chunk=16)
    s, i = search(_corpus(c, cl, store_dtype=getattr(torch, store)), q, ql, **kw)
    js, ji = jax_search(jax_build_corpus(c, cl, store_dtype=getattr(jnp, store)), q, ql, **kw)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), atol=TOL, rtol=0)


@pytest.mark.parametrize("rerank", [False, True])
def test_duplicated_rows_keep_lax_top_k_order(corpus_data, rerank):
    """A corpus whose rows come in identical pairs scores each pair equal:
    the port returns the lower index first, as lax.top_k does."""
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    dup, dup_lens = np.repeat(cap_embs[:30], 2, axis=0), np.repeat(cap_lens[:30], 2)
    kw = dict(direction="i2t", k=8, shortlist=16, rerank=rerank)
    s, i = search(_corpus(dup, dup_lens), img_embs, img_lens, **kw)
    js, ji = jax_search(jax_build_corpus(dup, dup_lens), img_embs, img_lens, **kw)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), atol=TOL, rtol=0)
    assert (s[:, 0::2] == s[:, 1::2]).all() and (i[:, 1::2] == i[:, 0::2] + 1).all()


@pytest.mark.parametrize("mode", tlat.MODES)
def test_serial_runner_matches_jax(corpus_data, mode):
    """Each mode's serial top-1 (t2i: caption queries, image corpus) equals
    aladin_tpu's scan on the same corpus and queries."""
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    corpus = _corpus(img_embs, img_lens)
    got = tlat.make_serial_runner(mode, shortlist=6, k=3)(
        torch.from_numpy(cap_embs), torch.from_numpy(cap_lens), corpus)
    want = jlat.make_serial_runner(mode, shortlist=6, k=3)(
        jnp.asarray(cap_embs), jnp.asarray(cap_lens), jax_build_corpus(img_embs, img_lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serial_runner_refuses_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        tlat.make_serial_runner("sideways")


@pytest.mark.parametrize("mode", tlat.MODES)
def test_serial_query_latency_on_cpu(corpus_data, mode):
    img_embs, img_lens, cap_embs, cap_lens = corpus_data
    sec, note = tlat.serial_query_latency(_corpus(img_embs, img_lens), cap_embs, cap_lens,
                                          mode=mode, shortlist=6, n_serial=8, repeats=2)
    assert (sec is not None and sec > 0 and note == "") or (sec is None and note)
    assert (tlat.REF_MATCHING_S, tlat.REF_ALIGNMENT_S) == (jlat.REF_MATCHING_S,
                                                           jlat.REF_ALIGNMENT_S)
