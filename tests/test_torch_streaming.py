"""Streaming recall (aladin_torch/eval/streaming.py) on the CPU against the
port's dense oracle and against aladin_tpu's streaming path, on the same
seeded numpy inputs.

Streamed ranks must equal the dense ranks of the same scorer exactly: the
ground truth comes from that scorer and the counts exclude the own entry by
index. Against aladin_tpu (XLA on the CPU; the Pallas MrSw kernel in
interpret mode) the scores are the same math summed in another order, so a
rank may differ only where the scores behind it are within 1e-4 of each
other: a near-tie, the rule of tests/test_torch_cli.py.
"""

import numpy as np
import pytest
import torch

import aladin_torch.eval.recall as trec
from aladin_torch.eval import streaming as tst
from aladin_torch.ops.alignment import AGGREGATIONS, score_all_pairs
from aladin_torch.ops.kernels.alignment_kernel import mrsw_scores
from aladin_torch.ops.similarity import l2norm
from aladin_torch.parallel.mesh import create_mesh
from aladin_tpu.eval import streaming as jst

N, CPI, D = 24, 5, 32
TOL = 1e-4


@pytest.fixture(scope="module")
def globs():
    rng = np.random.RandomState(0)
    ims = rng.randn(N, D).astype(np.float32)
    caps = rng.randn(N * CPI, D).astype(np.float32)
    ims /= np.linalg.norm(ims, axis=1, keepdims=True)
    caps /= np.linalg.norm(caps, axis=1, keepdims=True)
    return ims, caps


def _dense_ranks(scores: torch.Tensor):
    return tuple(r.numpy() for r in trec.ranks_from_score_matrix(scores, CPI))


@pytest.mark.parametrize("cap_block", [7, 40, 1024])
def test_matching_ranks_match_dense_and_jax(globs, cap_block):
    ims, caps = globs
    want = _dense_ranks(torch.from_numpy(ims) @ torch.from_numpy(caps).T)
    got = tst.streaming_matching_ranks(ims, caps, CPI, cap_block=cap_block, device="cpu")
    jax_got = jst.streaming_matching_ranks(ims, caps, CPI, cap_block=cap_block)
    for g, w, j in zip(got, want, jax_got):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.asarray(j))


def test_matching_takes_tensor_captions(globs):
    """Captions as a tensor (on the device) give the host array's ranks."""
    ims, caps = globs
    host = tst.streaming_matching_ranks(ims, caps, CPI, cap_block=16, device="cpu")
    dev = tst.streaming_matching_ranks(torch.from_numpy(ims), torch.from_numpy(caps), CPI,
                                       cap_block=16, device="cpu")
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h, d)


def test_matching_ground_truth_is_the_tiles_entry(globs):
    """gt[j] equals the sweep tile's entry (j // cpi, j) bit for bit."""
    ims, caps = globs
    t_ims, t_caps = torch.from_numpy(ims), torch.from_numpy(caps)
    gt = tst.matching_ground_truth(t_ims, caps, CPI, 16)
    tiles = torch.cat([tst._matching_tile(t_ims, torch.nn.functional.pad(
        t_caps[lo:lo + 40], (0, 0, 0, 40 - t_caps[lo:lo + 40].shape[0])))
        for lo in range(0, N * CPI, 40)], dim=1)
    j = torch.arange(N * CPI)
    assert torch.equal(gt, tiles[j // CPI, j])


@pytest.mark.parametrize("duplicate", [False, True])
def test_matching_topk_carry(globs, duplicate):
    """The running top-k equals a stable descending sort of the dense scores
    and aladin_tpu's carry; repeated caption rows keep lax.top_k's order
    (the lower id first)."""
    ims, caps = globs
    if duplicate:
        caps = caps.copy()
        caps[1::2] = caps[0::2]
    scores = torch.from_numpy(ims) @ torch.from_numpy(caps).T
    want = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :10].numpy()
    _, _, (tv, tc) = tst.streaming_matching_ranks(ims, caps, CPI, cap_block=16, topk=10,
                                                  device="cpu")
    _, _, (jv, jc) = jst.streaming_matching_ranks(ims, caps, CPI, cap_block=16, topk=10)
    np.testing.assert_array_equal(tc, want)
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_allclose(tv, np.take_along_axis(scores.numpy(), want, 1), rtol=1e-6)
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-6)


def test_matching_topk_wider_than_a_tile(globs):
    """topk above the tile width pads the first carry with -inf / -1."""
    ims, caps = globs
    _, _, (tv, tc) = tst.streaming_matching_ranks(ims, caps, CPI, cap_block=7, topk=12,
                                                  device="cpu")
    _, _, (jv, jc) = jst.streaming_matching_ranks(ims, caps, CPI, cap_block=7, topk=12)
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-6)


@pytest.fixture(scope="module")
def sets():
    rng = np.random.RandomState(1)
    n = 8
    img_sets = np.repeat(rng.randn(n, 9, D).astype(np.float32), CPI, axis=0)
    cap_seqs = rng.randn(n * CPI, 12, D).astype(np.float32)
    img_lens = np.repeat(rng.randint(4, 10, n), CPI).astype(np.int32)
    cap_lens = rng.randint(4, 13, n * CPI).astype(np.int32)
    return img_sets, cap_seqs, img_lens, cap_lens


def _assert_ranks_or_near_tie(got, want, scores):
    """Equal ranks, or a near-tie (< TOL) in the query's scores behind each
    difference. ``scores``: (N_im, N_cap) dense scores."""
    for s, g, w in ((scores, got[0], want[0]), (scores.T, got[1], want[1])):
        for q in np.nonzero(np.asarray(g) != np.asarray(w))[0]:
            gaps = np.abs(s[q][:, None] - s[q][None, :])
            np.fill_diagonal(gaps, np.inf)
            assert gaps.min() < TOL, (q, g[q], w[q])


@pytest.mark.parametrize("aggregation", AGGREGATIONS)
def test_alignment_ranks_match_dense_and_jax(sets, aggregation):
    """MrSw through K1's plain version (use_kernel, bf16 operands; aladin_tpu's
    Pallas kernel in interpret mode), the others through score_all_pairs in
    f32 (aladin_tpu's XLA path)."""
    img_sets, cap_seqs, img_lens, cap_lens = sets
    kernel = aggregation == "MrSw"
    ims = l2norm(torch.from_numpy(img_sets[::CPI]), eps=1e-12)
    caps = l2norm(torch.from_numpy(cap_seqs), eps=1e-12)
    il, cl = torch.from_numpy(img_lens[::CPI]), torch.from_numpy(cap_lens)
    if kernel:
        dense = mrsw_scores(ims, caps, il, cl)
    else:
        dense = score_all_pairs(ims, caps, il, cl, aggregation, 24, normalized=True)
    got = tst.streaming_alignment_ranks(img_sets, cap_seqs, img_lens, cap_lens, aggregation,
                                        CPI, cap_block=16, use_kernel=kernel, device="cpu")
    want = _dense_ranks(dense)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])

    jax_got = jst.streaming_alignment_ranks(img_sets, cap_seqs, img_lens, cap_lens, aggregation,
                                            CPI, cap_block=16, use_pallas=kernel,
                                            interpret=True)
    _assert_ranks_or_near_tie(got, jax_got, dense.numpy())


def test_alignment_use_kernel_defaults_to_the_card(sets, monkeypatch):
    """On CPU tensors use_kernel defaults off: MrSw goes through
    score_all_pairs in f32, as aladin_tpu's use_pallas does off the TPU."""
    img_sets, cap_seqs, img_lens, cap_lens = sets
    calls = []
    monkeypatch.setattr(tst, "mrsw_scores", lambda *a, **k: calls.append(1))
    got = tst.streaming_alignment_ranks(img_sets, cap_seqs, img_lens, cap_lens, "MrSw", CPI,
                                        cap_block=16, device="cpu")
    want = jst.streaming_alignment_ranks(img_sets, cap_seqs, img_lens, cap_lens, "MrSw", CPI,
                                         cap_block=16, use_pallas=False)
    assert not calls
    ims = l2norm(torch.from_numpy(img_sets[::CPI]), eps=1e-12)
    caps = l2norm(torch.from_numpy(cap_seqs), eps=1e-12)
    dense = score_all_pairs(ims, caps, torch.from_numpy(img_lens[::CPI]),
                            torch.from_numpy(cap_lens), "MrSw", 24, normalized=True)
    np.testing.assert_array_equal(got[0], _dense_ranks(dense)[0])
    np.testing.assert_array_equal(got[1], _dense_ranks(dense)[1])
    _assert_ranks_or_near_tie(got, want, dense.numpy())


def test_alignment_recall_dicts(sets):
    img_sets, cap_seqs, img_lens, cap_lens = sets
    i2t, t2i = tst.streaming_alignment_recall(img_sets, cap_seqs, img_lens, cap_lens, "MrSw",
                                              CPI, cap_block=16, use_kernel=True, device="cpu")
    ranks = tst.streaming_alignment_ranks(img_sets, cap_seqs, img_lens, cap_lens, "MrSw", CPI,
                                          cap_block=16, use_kernel=True, device="cpu")
    assert i2t == trec.recall_metrics(ranks[0]) and t2i == trec.recall_metrics(ranks[1])


def test_compute_recall_auto_engages_streaming(globs, monkeypatch):
    """Past STREAMING_SCORE_BYTES compute_recall streams: the same dict as
    the dense path and as aladin_tpu's, and no dense matrix."""
    from aladin_tpu.eval.recall import compute_recall as jax_compute_recall

    ims, caps = globs
    dup = np.repeat(ims, CPI, axis=0)
    want = trec.compute_recall(dup, caps, CPI, device="cpu")
    calls = []
    real = tst.streaming_matching_recall
    monkeypatch.setattr(tst, "streaming_matching_recall",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(trec, "STREAMING_SCORE_BYTES", 1)
    got = trec.compute_recall(dup, caps, CPI, device="cpu")
    assert calls == [1]
    assert got == want == jax_compute_recall(dup, caps, CPI)


@pytest.mark.parametrize("fn", ["matching", "alignment"])
def test_mesh_raises(globs, sets, fn):
    """A dp=1,tp=2 mesh for a streaming sweep in a process without a
    process group raises, naming the launch that gives it its 2 ranks; the
    mesh sweeps themselves are tests/test_torch_parallel.py's."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        if fn == "matching":
            tst.streaming_matching_ranks(*globs, CPI, mesh=create_mesh("dp=1,tp=2"),
                                         device="cpu")
        else:
            tst.streaming_alignment_ranks(*sets, mesh=create_mesh("dp=1,tp=2"), device="cpu")
