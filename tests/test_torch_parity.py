"""The port's parity harness (aladin_torch/cli/parity.py) on the CPU: the four
checks of tests/test_parity.py on the synthetic reference-format fixture,
and aladin_tpu's harness against the port's on one checkpoint.

Both harnesses evaluate a ``.pth.tar`` written by aladin_tpu's
``save_aladin_checkpoint`` from seeded parameters, with f32 encoders and f32
scoring (``--compute_dtype float32``). Tolerances, those of
tests/test_torch_cli.py: the 5k alignment scores within 1e-4; every R@K,
medr and rsum row of every protocol equal, unless an alignment rank
differs, and then every differing rank must sit on a near-tie (two scores
within 1e-4).
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax

import aladin_tpu.cli.parity as jax_parity
from aladin_torch.cli import parity as torch_parity
from tests.test_torch_cli import _assert_ranks_or_near_tie, checkpoint  # noqa: F401 - fixture
from tests.test_torch_threads import _two_threads  # noqa: F401 (autouse)

COMMON = ["--max_seq_length", "20", "--max_img_seq_length", "12", "--img_feature_dim", "32",
          "--synthetic", "--device", "cpu"]
RECIPE = "aladin_torch/configs/alad-alignment-and-matching-distill.json"
TOL = 1e-4


def _run(tmp_path, extra, workdir=None):
    workdir = workdir or str(tmp_path)
    report_dir = os.path.join(workdir, "parity")
    rc = torch_parity.main(["--config", RECIPE, "--output_dir", workdir,
                            "--report_dir", report_dir, "--latency_serial", "8",
                            *COMMON, *extra])
    rpath = os.path.join(report_dir, "parity_report.json")
    report = json.load(open(rpath)) if os.path.exists(rpath) else None
    return rc, report, report_dir


def test_parity_harness_sections(tmp_path):
    """The one command produces every section of the report: both heads on
    1k/5k/5-fold, latency, and gating checks; exit 0."""
    rc, report, report_dir = _run(tmp_path, [])
    assert rc == 0
    for proto in ("matching_5k", "alignment_5k", "matching_5fold",
                  "alignment_5fold", "matching_1k", "alignment_1k"):
        assert "rsum" in report["results"][proto], proto
    # the 1k subset must be a strict subset of the 5k set (fixture halves)
    assert 0 < report["n_images_1k"] < report["n_images_5k"]
    assert report["latency"]["matching_serial_s_per_query"] is None or \
        report["latency"]["matching_serial_s_per_query"] > 0
    assert set(report["latency"]) >= {"matching_serial_s_per_query",
                                      "two_stage_serial_s_per_query",
                                      "alignment_serial_s_per_query"}
    names = {c["check"] for c in report["checks"]}
    assert names == {"matching_rsum_1k", "alignment_rsum_1k",
                     "matching_serial_s_per_query",
                     "alignment_serial_s_per_query"}
    # joint profile (loss-type alignment-distillation): matching row gates
    by = {c["check"]: c["status"] for c in report["checks"]}
    assert by["matching_rsum_1k"] in ("PASS", "FAIL")
    assert by["alignment_rsum_1k"].startswith("INFO")
    md = open(os.path.join(report_dir, "parity_report.md")).read()
    assert "Gating checks" in md and "Overall:" in md


def test_parity_strict_gating_and_overrides(tmp_path):
    """--expected_json targets gate regardless of profile; --strict turns a
    FAIL into exit 1; achievable targets pass."""
    impossible = tmp_path / "impossible.json"
    impossible.write_text(json.dumps({"alignment_rsum_1k": 9999.0}))
    rc, report, _ = _run(
        tmp_path, ["--strict", "--skip_latency",
                   "--expected_json", str(impossible)],
        workdir=str(tmp_path / "a"))
    assert rc == 1 and report["pass"] is False
    by = {c["check"]: c["status"] for c in report["checks"]}
    assert by["alignment_rsum_1k"] == "FAIL"

    achievable = tmp_path / "achievable.json"
    achievable.write_text(json.dumps({
        "alignment_rsum_1k": report["results"]["alignment_1k"]["rsum"],
        "matching_rsum_1k": report["results"]["matching_1k"]["rsum"],
    }))
    rc2, report2, _ = _run(
        tmp_path, ["--strict", "--skip_latency",
                   "--expected_json", str(achievable)],
        workdir=str(tmp_path / "b"))
    assert rc2 == 0 and report2["pass"] is True


def test_subset_rows_order_and_missing(tmp_path):
    """_subset_rows returns buffer rows grouped per image, in keys-file
    order, and tolerates keys absent from the split; the same rows as
    aladin_tpu's."""
    keys_path = tmp_path / "keys.tsv"
    keys_path.write_text("104\n101\n999\n")
    logger = logging.getLogger("test")
    rows, n = torch_parity._subset_rows([100, 101, 102, 103, 104], 5, str(keys_path), logger)
    assert n == 2
    np.testing.assert_array_equal(
        rows, np.concatenate([np.arange(20, 25), np.arange(5, 10)]))
    jrows, jn = jax_parity._subset_rows([100, 101, 102, 103, 104], 5, str(keys_path), logger)
    np.testing.assert_array_equal(rows, jrows)
    assert n == jn


def test_parity_on_released_format_checkpoint(checkpoint, tmp_path):  # noqa: F811
    """The day-one command on a reference-format .pth.tar: full coverage
    (0 missing / 0 unused), the joint profile; orbax directories refused."""
    _, ckpt = checkpoint
    rc, report, _ = _run(tmp_path, ["--load_checkpoint", ckpt, "--compute_dtype", "float32"])
    assert rc == 0
    cov = report["coverage"]
    assert cov["matched"] > 20 and cov["missing"] == 0 and cov["unused"] == 0
    assert report["checkpoint"] == ckpt
    assert report["profile"] == "joint"
    with pytest.raises(NotImplementedError, match="orbax"):
        _run(tmp_path / "orbax", ["--load_checkpoint", str(tmp_path)])


def test_parity_rows_match_jax_harness(checkpoint, tmp_path, monkeypatch):  # noqa: F811
    """aladin_tpu's harness and the port's on one checkpoint and fixture (f32
    encoders and scoring): the same report sections and checks, every
    protocol's R@K / medr / rsum rows equal (near-ties allowed as stated)."""
    _, ckpt = checkpoint
    seen = []
    real = jax_parity.evaluate_alignment_head

    def record(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(jax_parity, "evaluate_alignment_head", record)
    common = ["--load_checkpoint", ckpt, "--compute_dtype", "float32", "--latency_serial", "4",
              "--max_seq_length", "20", "--max_img_seq_length", "12", "--img_feature_dim", "32",
              "--synthetic"]
    jdir = str(tmp_path / "jax")
    assert jax_parity.main(common + ["--output_dir", jdir, "--report_dir", jdir,
                                     "--mesh_shape", "dp=1"]) == 0
    want = json.load(open(os.path.join(jdir, "parity_report.json")))
    tdir = str(tmp_path / "torch")
    got = torch_parity.run(common + ["--output_dir", tdir, "--report_dir", tdir,
                                     "--device", "cpu"])
    report = got["report"]
    assert set(report) == set(want)
    assert set(report["results"]) == set(want["results"])
    assert [c["check"] for c in report["checks"]] == [c["check"] for c in want["checks"]]
    assert set(report["latency"]) == set(want["latency"])
    assert (report["n_images_5k"], report["n_images_1k"], report["profile"]) == (
        want["n_images_5k"], want["n_images_1k"], want["profile"])

    want_scores = np.asarray(seen[0][2])
    np.testing.assert_allclose(got["scores_5k"], want_scores, atol=TOL, rtol=0)
    _assert_ranks_or_near_tie(got["scores_5k"], want_scores, TOL)
    ties = not all(np.array_equal(np.argsort(-got["scores_5k"][q], kind="stable"),
                                  np.argsort(-want_scores[q], kind="stable"))
                   for q in range(want_scores.shape[0]))
    for proto, rows in want["results"].items():
        if ties and proto.startswith("alignment"):
            continue  # a near-tie flip may move an alignment row (checked above)
        for key, v in rows.items():
            assert report["results"][proto][key] == pytest.approx(v, abs=1e-9), (proto, key)
