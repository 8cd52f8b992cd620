"""The command refuses to measure without a card: no CPU number is ever
reported under a device metric."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from h100_bench.tests.tiny import ROOT


@pytest.mark.parametrize("trace", ["0", "1"])
def test_run_exits_nonzero_without_a_card(trace):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "aladin.score_5k",
                          "--seed", str(2 ** 33 + 5), "--seconds", "1", "--trace", trace],
                         capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_refuses_an_unknown_workload():
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "no.such_cell",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_cache_directories_are_fixed_inside_the_checkout():
    from h100_bench import run

    saved = dict(os.environ)
    try:
        run.cache_env(ROOT)
        first = os.environ["TRITON_CACHE_DIR"]
        run.cache_env(ROOT)
        assert os.environ["TRITON_CACHE_DIR"] == first
        assert first.startswith(os.path.join(ROOT, "h100_bench") + os.sep)
        assert os.environ["USE_FLAX"] == "0"
    finally:
        os.environ.clear()
        os.environ.update(saved)
