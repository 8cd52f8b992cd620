"""The harness: finds a cell's configuration, traffic, runner and metric
readers by name, runs set-up, the measured window and the output check,
and builds the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own under the benchmark's directory, found by the name that
``BENCHMARK.json`` gives:

  * ``configs/<config>.json``: the configuration's file (the manifest's
    ``file`` entry names it);
  * ``traffic/<traffic>.json``: the mix's parameters; its ``runner`` key
    names the code that drives the program, ``runners/<runner>.py``;
  * ``metrics/<metric>.py``: the reader of one metric, ``read(result)``,
    which returns a number or None (nothing to read: the metric is left
    out of the line).

A runner module has ``setup(ctx) -> workload``; the workload has
``unit() -> items`` (one unit of work, as the user calls it), ``drain()``
(wait for queued work), ``counters()`` (work counted from shapes, for the
readers), ``failed()``, ``release()`` (drop the program's state) and
``check() -> [(name, value, limit)]`` (the comparison with the plain
reference, run after ``release``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from h100_bench.lib import smi
from h100_bench.lib import trace as T

BENCH_DIR = "h100_bench"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "aladin_tpu")


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(root: str, manifest: dict, config: str) -> str:
    for c in manifest["configs"]:
        if c["name"] == config:
            return os.path.join(root, c["file"])
    raise KeyError(f"no configuration {config!r} in BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_file(root: str, traffic: str) -> str:
    return os.path.join(root, BENCH_DIR, "traffic", f"{traffic}.json")


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_runner(root: str, runner: str):
    return _module(os.path.join(root, BENCH_DIR, "runners", f"{runner}.py"),
                   f"h100_bench_runner_{runner}")


def load_reader(root: str, metric: str) -> Callable:
    mod = _module(os.path.join(root, BENCH_DIR, "metrics", f"{metric}.py"),
                  "h100_bench_metric_" + metric.replace(".", "_").replace("-", "_"))
    return mod.read


def cell_metrics(manifest: dict, cell: str, kind: str) -> List[dict]:
    """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"): those
    that list it under ``workloads``; an end-to-end metric without the key
    (``setup_s``) goes with every cell."""
    if kind == "end_to_end":
        return [m for m in manifest["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]
    return [m for m in manifest["per_layer"] if cell in m["workloads"]]


@dataclasses.dataclass
class Context:
    """What a runner's set-up gets: the run's seed and device, the
    configuration's and the traffic file's contents."""

    seed: int
    device: torch.device
    config: dict
    traffic: dict


@dataclasses.dataclass
class Result:
    """What a metric reader gets."""

    setup_s: float
    window_s: float
    units: int
    items: int
    latencies_s: List[float]
    counters: Dict[str, Any]
    view: Optional[T.TraceView]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(root: str, cell_name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, chips: int = 1,
             config_over: Optional[dict] = None,
             traffic_over: Optional[dict] = None) -> Tuple[dict, dict]:
    """One run of a cell: set-up, the window, the check. Returns the
    result line as a dict (``checks`` last) and notes on the window (its
    units, their seconds' quantiles, the card's clocks and power).
    ``config_over`` / ``traffic_over`` replace keys of the files (the CPU
    tests' tiny sizes)."""
    manifest = load_manifest(root)
    cell = find_cell(manifest, cell_name)
    config = load_json(config_file(root, manifest, cell["config"]))
    config.update(config_over or {})
    traffic = load_json(traffic_file(root, cell["traffic"]))
    traffic.update(traffic_over or {})
    runner = load_runner(root, traffic["runner"])
    kind = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: (m["unit"], load_reader(root, m["name"]))
               for m in cell_metrics(manifest, cell_name, kind)}

    ctx = Context(seed=seed, device=device, config=config, traffic=traffic)
    work = runner.setup(ctx)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    length = min(seconds, float(traffic.get("trace_seconds", seconds))) if trace else seconds
    latencies: List[float] = []
    items = units = 0
    tracer = T.Tracer() if trace else None
    if tracer is not None:
        tracer.__enter__()
    try:
        with smi.SmiSampler() if device.type == "cuda" else T.nothing() as sampler, \
                T.span(T.WINDOW_SPAN):
            t0 = time.perf_counter()
            while True:
                u0 = time.perf_counter()
                items += work.unit()
                u1 = time.perf_counter()
                latencies.append(u1 - u0)
                units += 1
                if u1 - t0 >= length:
                    break
            work.drain()
            _sync(device)
            window_s = time.perf_counter() - t0
    finally:
        if tracer is not None:
            tracer.__exit__(*sys.exc_info())
    view = tracer.view if tracer is not None else None

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counters = work.counters()
    failed = work.failed()
    work.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = [(n, float(v), float(lim)) for n, v, lim in work.check()]
    del work

    res = Result(setup_s=setup_s, window_s=view.window_s if view is not None else window_s,
                 units=units, items=items, latencies_s=latencies, counters=counters, view=view)
    metrics = {}
    for name, (unit, read) in readers.items():
        value = read(res)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if view is not None:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
    line_notes = {"units": units, "unit_s": [T.percentile(latencies, q) for q in (0, 50, 95, 100)],
                  "smi": sampler.summary if sampler is not None else None}
    correct = (bool(checks) and failed == 0
               and all(math.isfinite(v) and v <= lim for _, v, lim in checks))
    line = {"correct": correct, "attempted": items, "failed": failed, "metrics": metrics,
            "device": dev}
    if view is not None:
        line["breakdown"] = {"device_ops": view.device_ops(), "idle_gaps": view.idle_gaps()}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line, line_notes


def forbidden_loaded() -> List[str]:
    """Top-level names in ``sys.modules`` that the port must not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))
