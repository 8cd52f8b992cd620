"""On the card: each cell's check at the cell's own sizes (a few units on
one seed) passes for the program, and the cell's lower-precision control
fails it. Skips without a CUDA device.

    python -m pytest h100_bench/tests/test_h100_gpu.py -m gpu -q -p no:cacheprovider
"""

from __future__ import annotations

import math

import pytest
import torch

from h100_bench.lib import harness
from h100_bench.tests.tiny import ROOT

pytestmark = pytest.mark.gpu
CELLS = ("aladin.train_bs32", "caption.greedy_kv512", "aladin.score_5k", "aladin.t2i_search")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from h100_bench.run import cache_env

    cache_env(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def passes(readings):
    return all(math.isfinite(v) and v <= lim for _, v, lim in readings)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(card, cell):
    manifest = harness.load_manifest(ROOT)
    w = harness.find_cell(manifest, cell)
    config = harness.load_json(harness.config_file(ROOT, manifest, w["config"]))
    traffic = harness.load_json(harness.traffic_file(ROOT, w["traffic"]))
    runner = harness.load_runner(ROOT, traffic["runner"])
    ctx = harness.Context(seed=2 ** 31 + 77, device=card, config=config, traffic=traffic)
    work = runner.setup(ctx)
    for _ in range(3):
        work.unit()
    work.drain()
    assert work.failed() == 0
    work.release()
    torch.cuda.empty_cache()
    program = work.check()
    assert passes(program), program
    for name, readings in runner.control(work).items():
        assert not passes(readings), (name, readings)
