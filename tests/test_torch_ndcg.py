"""NDCG in the port against aladin_tpu on the CPU: the DCG math and the
relevance-matrix scorer, dense and five-fold retrieval metrics with a
scorer, rougeL relevance matrices, and ``--ndcg`` through cli/test (both
packages on one checkpoint) and cli/train (the best-NDCG checkpoint).

Relevance matrices are raw float32 (n_queries, n_images) files written from
a seed, as the reference's offline builder writes them. The DCG math is
numpy in both packages: equal within 1e-12; metrics read from f32 score
matrices: within 1e-6.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from aladin_tpu.eval import dcg as jax_dcg
from aladin_tpu.eval import relevance as jax_relevance
from aladin_tpu.eval import retrieval as jax_retrieval
from aladin_torch.cli import train as torch_train_cli
from aladin_torch.eval import dcg, relevance, retrieval
from tests.test_torch_cli import _both_clis, checkpoint  # noqa: F401 (a fixture)
from tests.test_torch_train import CLI as TRAIN_CLI

METHODS = ("rougeL", "spice")


def _write_relevances(rel_dir, split, n_queries, n_images, seed=0, dataset="coco"):
    os.makedirs(rel_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for m in METHODS:
        rng.rand(n_queries, n_images).astype(np.float32).tofile(
            os.path.join(rel_dir, f"{dataset}-{split}-{m}.npy"))


def _scorers(rel_dir, n_queries, split="test"):
    cfg = {"dataset": {"name": "coco", "data": "unused"}}
    return (dcg.DCG(cfg, n_queries, split, relevance_methods=METHODS, rel_dir=rel_dir),
            jax_dcg.DCG(cfg, n_queries, split, relevance_methods=METHODS, rel_dir=rel_dir))


def test_dcg_math_matches(rng):
    for _ in range(20):
        y = rng.rand(30) * rng.randint(0, 3)
        ranking = rng.permutation(30)[:25]
        score = rng.randn(30)
        assert dcg.dcg_from_ranking(y, ranking) == pytest.approx(
            jax_dcg.dcg_from_ranking(y, ranking), abs=1e-12)
        assert dcg.ndcg_from_ranking(y, ranking) == pytest.approx(
            jax_dcg.ndcg_from_ranking(y, ranking), abs=1e-12)
        for gains in ("exponential", "linear"):
            assert dcg.ndcg_score(y, score, 10, gains) == pytest.approx(
                jax_dcg.ndcg_score(y, score, 10, gains), abs=1e-12)
    assert dcg.ndcg_from_ranking(np.zeros(5), np.arange(5)) == 0.0
    with pytest.raises(ValueError):
        dcg.ndcg_score(np.ones(3), np.ones(3), gains="cubic")


@pytest.mark.parametrize("retrieval_kind", ["image", "sentence"])
def test_compute_ndcg_matches(rng, tmp_path, retrieval_kind):
    """Both directions, folds 0 and 2 of a (50, 10) matrix (npts 2 a fold)."""
    _write_relevances(str(tmp_path), "test", 50, 10)
    ours, ref = _scorers(str(tmp_path), 50)
    npts = 2
    n = npts if retrieval_kind == "sentence" else 5 * npts
    for fold in (0, 2):
        for q in range(n):
            order = rng.permutation(5 * npts if retrieval_kind == "sentence" else npts)
            got = ours.compute_ndcg(npts, q, order, fold, retrieval_kind)
            want = ref.compute_ndcg(npts, q, order, fold, retrieval_kind)
            assert set(got) == set(METHODS)
            for m in METHODS:
                assert got[m] == pytest.approx(want[m], abs=1e-12)


@pytest.mark.parametrize("fivefold", [False, True], ids=["dense", "fivefold"])
def test_retrieval_metrics_with_scorer_match(rng, tmp_path, fivefold):
    """R@K, medr and both NDCG fields of both directions, from one f32
    (10, 50) score matrix, dense and as five folds of 2 images."""
    _write_relevances(str(tmp_path), "test", 50, 10)
    ours, ref = _scorers(str(tmp_path), 50)
    scores = rng.randn(10, 50).astype(np.float32)
    if fivefold:
        got = retrieval.fivefold_from_scores(torch.from_numpy(scores), ndcg_scorer=ours)
        want = jax_retrieval.fivefold_from_scores(scores, ndcg_scorer=ref)
    else:
        got = retrieval.retrieval_metrics_from_scores(torch.from_numpy(scores), 5, ours)
        want = jax_retrieval.retrieval_metrics_from_scores(scores, 5, ref)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["ndcg_rougel"] > 0 and g["ndcg_spice"] > 0
        for key, v in w.items():
            assert g[key] == pytest.approx(float(v), abs=1e-6), key


def test_scorer_with_one_method_reports_zero_for_the_other(rng, tmp_path):
    """The scorer's dict is read by method name: spice alone fills
    ndcg_spice and leaves ndcg_rougel at 0."""
    _write_relevances(str(tmp_path), "test", 50, 10)
    spice_only = dcg.DCG({"dataset": {"name": "coco"}}, 50, "test", relevance_methods=["spice"],
                         rel_dir=str(tmp_path))
    i2t, t2i = retrieval.retrieval_metrics_from_scores(
        torch.from_numpy(rng.randn(10, 50).astype(np.float32)), 5, spice_only)
    for m in (i2t, t2i):
        assert m["ndcg_rougel"] == 0.0 and m["ndcg_spice"] > 0


def _stub_spice(tmp_path, monkeypatch):
    """Both packages' spice modules on tests/test_spice_protocol.py's stub
    interpreter and a placeholder jar."""
    from aladin_tpu.eval import spice as jax_spice
    from aladin_torch.eval import spice
    from tests.test_spice_protocol import STUB

    (tmp_path / "fake_jvm.py").write_text(STUB)
    (tmp_path / "fake.jar").write_text("not a real jar")
    for mod in (spice, jax_spice):
        monkeypatch.setattr(mod, "JAVA", [sys.executable, str(tmp_path / "fake_jvm.py")])
        monkeypatch.setattr(mod, "SPICE_JAR", str(tmp_path / "fake.jar"))


def test_rouge_relevances_match(tmp_path, monkeypatch):
    """rougeL, meteor and spice relevances equal aladin_tpu's."""
    queries = [["a dog on the grass"], ["A cat sleeps", "the cat on a sofa"],
               ["two people ride bikes"]]
    images = [["a dog runs on grass", "the brown dog"], ["a cat on a sofa", "cat sleeping"],
              ["people riding bikes on a road", "two cyclists"], ["an empty room"]]
    got = relevance.compute_relevances(queries, images, str(tmp_path / "ours.npy"),
                                       num_workers=1)
    want = jax_relevance.compute_relevances(queries, images, str(tmp_path / "ref.npy"),
                                            num_workers=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.shape == (3, 4) and got[0, 0] > got[0, 3]
    raw = np.fromfile(str(tmp_path / "ours.npy"), dtype=np.float32)  # no .npy header
    np.testing.assert_array_equal(raw.reshape(3, 4), np.asarray(want))
    for method in ("meteor", "spice"):
        if method == "spice":  # the jar's protocol against a stub interpreter
            _stub_spice(tmp_path, monkeypatch)
        got = relevance.compute_relevances(queries, images, str(tmp_path / f"{method}.npy"),
                                           method, num_workers=1)
        want = jax_relevance.compute_relevances(queries, images,
                                                str(tmp_path / f"{method}_ref.npy"), method,
                                                num_workers=1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert got[0, 0] > got[0, 3]


@pytest.mark.parametrize("flags", [["--ndcg"], ["--ndcg", "--fivefold"]],
                         ids=["dense", "fivefold"])
def test_cli_test_ndcg_matches_jax(checkpoint, monkeypatch, flags):  # noqa: F811
    """cli/test --ndcg in both packages on one checkpoint and one pair of
    synthetic (40, 8) test relevance matrices: both NDCG fields of both
    directions above 0 and within 1e-6 (f32 scoring)."""
    work, _ = checkpoint
    tag = "_".join(flags)
    for pkg in ("jax", "torch"):
        _write_relevances(os.path.join(work, pkg + tag, "synthetic_coco_ir", "relevances"),
                          "test", 40, 8)
    got, seen = _both_clis(checkpoint, monkeypatch, tag, flags)
    want_i2t, want_t2i = seen["fivefold_from_scores" if "--fivefold" in flags
                              else "evaluate_alignment_head"][:2]
    for g, w in ((got["alignment_i2t"], want_i2t), (got["alignment_t2i"], want_t2i)):
        for key in ("ndcg_rougel", "ndcg_spice"):
            assert g[key] > 0
            assert g[key] == pytest.approx(float(w[key]), abs=1e-6), key
    assert got["ndcg_seconds"] > 0


def test_cli_train_ndcg_writes_the_best_ndcg_checkpoint(tmp_path):
    """cli/train --ndcg over synthetic (40, 8) minival relevances: the
    validation logs NDCG above 0 and model_best_ndcgspice.pth.tar is
    written beside model_best_rsum.pth.tar."""
    out, run = str(tmp_path), str(tmp_path / "run")
    _write_relevances(os.path.join(out, "synthetic_coco_ir", "relevances"), "minival", 40, 8)
    res = torch_train_cli.run(TRAIN_CLI + ["--output_dir", out, "--logger_name", run,
                                           "--num_epochs", "1", "--ndcg"])
    assert res["trainer"].best_ndcgspice > 0
    for name in ("model_best_rsum.pth.tar", "model_best_ndcgspice.pth.tar"):
        assert os.path.exists(os.path.join(run, name)), name
    with open(os.path.join(run, "log.txt")) as f:
        m = re.search(r"ndcg_rouge (\d+\.\d+) ndcg_spice (\d+\.\d+)", f.read())
    assert m and float(m.group(1)) > 0 and float(m.group(2)) > 0, m


def test_cli_train_without_relevances_has_no_best_ndcg_checkpoint(tmp_path):
    """--ndcg with no relevance files: no scorer, NDCG 0, no best-NDCG copy."""
    run = str(tmp_path / "run")
    res = torch_train_cli.run(TRAIN_CLI + ["--output_dir", str(tmp_path), "--logger_name", run,
                                           "--num_epochs", "1", "--ndcg"])
    assert res["trainer"].ndcg_scorer is None
    assert not os.path.exists(os.path.join(run, "model_best_ndcgspice.pth.tar"))
