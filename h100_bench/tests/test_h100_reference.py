"""Each cell at a tiny size on the CPU: set-up, units and the check against
its plain reference come out correct; the yardstick's arithmetic equals
the program's and brute-force counts; the generator gives every seed the
same sizes."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from h100_bench.lib import bounds, traffic
from h100_bench.tests import tiny


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_tiny_cell_is_correct_on_the_cpu(cell):
    line = tiny.run(cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2
    for c in line["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]


@pytest.mark.parametrize("shape", [(32, 50, 50, 34), (128, 50, 50, 34), (8, 20, 30, 12)])
def test_train_flops_equal_the_programs(shape):
    from aladin_torch.utils.profiling import train_step_model_flops

    assert bounds.train_step_model_flops(*shape) == train_step_model_flops(*shape)


def test_k1_valid_ops_equal_a_brute_force_count():
    gen = torch.Generator().manual_seed(3)
    il = torch.randint(2, 7, (5,), generator=gen)
    cl = torch.randint(4, 9, (7,), generator=gen)
    d = 16
    count = 0
    for i in il.tolist():
        for c in cl.tolist():
            for _r in range(1, i):  # the special slot stripped
                for _w in range(1, c - 2):  # CLS and the last two slots stripped
                    count += 2 * d  # one multiply and one add per coordinate
    assert bounds.mrsw_valid_ops(d, il.tolist(), cl.tolist()) == count


def test_k1_bound_equals_chip_smokes():
    import chip_smoke

    gen = torch.Generator().manual_seed(4)
    ims, caps = torch.zeros(6, 9, 32), torch.zeros(11, 13, 32)
    il, cl = torch.randint(3, 10, (6,), generator=gen), torch.randint(4, 14, (11,), generator=gen)
    ms, kind = chip_smoke.mrsw_bound((ims, caps, il, cl), "bf16")
    s, kind2 = bounds.mrsw_bound(6, 9, 11, 13, 32, il.tolist(), cl.tolist(), "bf16")
    assert kind == kind2 and s * 1e3 == pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("backward", [False, True])
def test_attention_bound_equals_chip_smokes(backward):
    import chip_smoke

    ms, kind = chip_smoke.attention_bound(32, 84, 12, 64, 1, backward)
    s, kind2 = bounds.attention_bound(32, 84, 12, 64, 1, backward)
    assert kind == kind2 and s * 1e3 == pytest.approx(ms, rel=1e-12)


def test_caption_flops_count_a_step_by_hand():
    one = bounds.caption_decode_flops([3], [2], 1, 4, 1, 8, 10, 5)
    linear = 2.0 * (4 * 16 + 2 * 4 * 8)
    want = (2.0 * 2 * 5 * 4                      # region projection
            + 3 * (linear + 4.0 * 3 * 4)         # prefill of 3 context tokens
            + 2 * (linear + 4.0 * (3 + 0 + 2) * 4)  # one step, two tokens
            + 2.0 * 16 + 2.0 * 4 * 10)           # MLM head on one row
    assert one == want


@pytest.mark.parametrize("spec", [
    {"gamma": {"shape": 2.0, "scale": 2.5, "shift": 9, "min": 8, "max": 50}},
    {"choice": [[34, 0.85], [30, 0.05], [25, 0.05], [20, 0.05]]},
    {"uniform": [8, 30]}, {"fixed": 7}])
def test_every_seed_gets_the_same_sizes_in_another_order(spec):
    a = traffic.lengths(spec, 1000, 2 ** 33 + 1, 11)
    b = traffic.lengths(spec, 1000, 5, 11)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert np.array_equal(a, traffic.lengths(spec, 1000, 2 ** 33 + 1, 11))
    if len(np.unique(a)) > 1:
        assert not np.array_equal(a, b)


def test_caption_lengths_are_coco_like():
    m = traffic.multiset({"gamma": {"shape": 2.0, "scale": 2.5, "shift": 9, "min": 8,
                                    "max": 50}}, 25000)
    assert 13.5 < m.mean() < 14.5 and m.min() >= 8 and m.max() > 30
