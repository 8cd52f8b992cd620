"""A later change adds a cell, a traffic mix and a metric as new files and
new entries in BENCHMARK.json, editing no file the benchmark has: a copy
of the benchmark in a temporary directory gets them and the harness picks
them up by name."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

from h100_bench.lib import harness
from h100_bench.tests import tiny

NEW_MIX = {"runner": "score_alignment",
           "why": "a smaller test set: 3 captions an image",
           "images": 10, "captions_per_image": 3, "region_slots": 6, "word_slots": 10,
           "regions": {"fixed": 6}, "caption_tokens": {"uniform": [4, 10]}, "signal": 0.2,
           "check_rows": 3, "limits": {"score_err": 0.05, "recall_err": 0.0}}
NEW_E2E = '''"""Scoring calls a second."""


def read(r):
    return r.units / r.window_s
'''
NEW_LAYER = '''"""Pairs a call."""


def read(r):
    return r.items / r.units
'''


@pytest.fixture
def copy(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(tiny.ROOT, "h100_bench"), os.path.join(root, "h100_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: open(p, "rb").read() for p in _files(root)}
    with open(os.path.join(root, "h100_bench", "traffic", "score_small.json"), "w") as f:
        json.dump(NEW_MIX, f)
    with open(os.path.join(root, "h100_bench", "metrics", "score_calls_per_s.py"), "w") as f:
        f.write(NEW_E2E)
    with open(os.path.join(root, "h100_bench", "metrics", "score.pairs_per_call.py"), "w") as f:
        f.write(NEW_LAYER)
    path = os.path.join(root, "BENCHMARK.json")
    m = json.load(open(path))
    m["workloads"].append({"name": "aladin.score_small", "config": "aladin-vinvl-base",
                           "traffic": "score_small", "chips": 1, "why": NEW_MIX["why"]})
    m["end_to_end"].append({"name": "score_calls_per_s", "unit": "calls/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["aladin.score_small"]})
    m["end_to_end"][[e["name"] for e in m["end_to_end"]].index("score_pairs_per_s")][
        "workloads"].append("aladin.score_small")
    m["per_layer"].append({"name": "score.pairs_per_call", "unit": "pairs", "better": "higher",
                           "source": "program_counter", "layer": "eval (eval/retrieval.py)",
                           "moves": "score_calls_per_s", "workloads": ["aladin.score_small"]})
    with open(path, "w") as f:
        json.dump(m, f)
    return root, before


def _files(root):
    bench = os.path.join(root, "h100_bench")
    return sorted(os.path.join(b, f) for b, _, fs in os.walk(bench) for f in fs
                  if "__pycache__" not in b)


def test_new_files_are_picked_up_without_editing_any(copy):
    root, before = copy
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
    manifest = harness.load_manifest(root)
    layers = [m["name"] for m in harness.cell_metrics(manifest, "aladin.score_small", "per_layer")]
    assert layers == ["score.pairs_per_call"]
    line, _ = harness.run_cell(root, "aladin.score_small", 2 ** 32 + 3, 0.2, False,
                               torch.device("cpu"), 0.0, config_over=tiny.BACKBONE)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", "score_pairs_per_s", "score_calls_per_s"}
    assert line["metrics"]["score_calls_per_s"]["unit"] == "calls/s"
    assert line["attempted"] % (10 * 30) == 0
