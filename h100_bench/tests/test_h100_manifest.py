"""BENCHMARK.json against the benchmark's format: names, units, keys,
files found by name, each cell's metrics, bounds and run length."""

from __future__ import annotations

import json
import os
import re

import pytest

from h100_bench.lib import harness
from h100_bench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    return harness.load_manifest(ROOT)


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_command(manifest):
    assert set(manifest) == TOP_KEYS
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert all(not w.startswith("/") and ".." not in w for w in cmd)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    files = [w for w in cmd if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in manifest["paths"]) for f in files)
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_the_required_keys_and_names(manifest, section):
    entries = manifest[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        required = ENTRY_KEYS[section] | ({"workloads"} if section == "per_layer" else set())
        extra = {"workloads"} if section == "end_to_end" else set()
        assert required <= set(e) <= required | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer"):
            if key in e:
                assert one_line(e[key]), (e["name"], key)


def test_metric_names_are_unique_across_sections(manifest):
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))


def test_configs_files_and_reduced_keys(manifest):
    widths = re.compile(r"(_dim$|_rank$|hidden_size|intermediate|latent|state|proj|head|expan"
                        r"|experts_per)", re.I)
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert c["name"] in used
        assert one_line(c["source"]) and c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not widths.search(key), key


def test_workloads_resolve_to_files(manifest):
    pairs = set()
    configs = {c["name"] for c in manifest["configs"]}
    four = 0
    for w in manifest["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and one_line(w["why"])
        four += w["chips"] == 4
        traffic = harness.load_json(harness.traffic_file(ROOT, w["traffic"]))
        assert os.path.exists(os.path.join(ROOT, "h100_bench", "runners",
                                           traffic["runner"] + ".py"))
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_every_metric_has_a_reader(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(harness.load_reader(ROOT, m["name"])), m["name"]


def test_bounds_and_sources(manifest):
    names = {m["name"] for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    assert "setup_s" in names
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in names
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_each_cell_reports_setup_another_end_to_end_and_a_layer(manifest):
    for w in manifest["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(manifest, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layers = harness.cell_metrics(manifest, w["name"], "per_layer")
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_check_time_fits_with_24_cells(manifest):
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_metrics_of_one_layer_give_one_layer_name(manifest):
    names = {}
    for m in manifest["per_layer"]:
        names.setdefault(m["layer"].split()[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in names.values()), names
