"""The traced window: a ``torch.profiler`` capture of the card's operations
and the benchmark's own spans, and what the per-layer readers take from it.

torch.profiler (torch 2.11, CUDA 12.8) loses the first device records of a
trace, more with every trace a process takes, so a trace opens with
``PAD`` spin kernels (as ``chip_smoke.py::device_profile`` does) and is
refused unless some of them were kept: whatever was lost lies in the pad.

The trace is written as a Chrome trace into ``TMPDIR``, read and deleted.
Device operations are the events of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; spans are the ``user_annotation``
events that ``span(name)`` records on the host. The window is the span
``bench.window``: the device's busy time is the union of the device
operations' intervals inside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PAD = 512
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def span(name: str):
    """A host span around a call into one layer (a profiler annotation)."""
    return torch.profiler.record_function(name)


class TraceView:
    """The parsed trace: device operations and host spans inside the
    window, with the readers' conveniences."""

    def __init__(self, events: List[dict]):
        window = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == WINDOW_SPAN]
        if not window:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        w = window[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.pad_kept = sum(1 for e in device if PAD_KERNEL in e.get("name", ""))
        if not self.pad_kept:
            raise RuntimeError(f"the profiler kept none of the {PAD} pad kernels: records of "
                               f"the window may be lost")
        self.ops: List[Tuple[str, float, float]] = sorted(
            (e["name"], float(e["ts"]), float(e["dur"])) for e in device
            if PAD_KERNEL not in e.get("name", "")
            and float(e["ts"]) + float(e["dur"]) > self.t0 and float(e["ts"]) < self.t1)
        self.spans: List[Tuple[str, float, float]] = sorted(
            ((e["name"], float(e["ts"]), float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") != WINDOW_SPAN
             and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0),
            key=lambda s: (s[1], -s[2]))
        self.busy_intervals = self._merged()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals) / 1e6

    def _merged(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, ts, dur in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def op_seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name contains ``pattern``."""
        return sum(d for n, _, d in self.ops if pattern in n) / 1e6

    def span_durations(self, name: str) -> List[float]:
        """Seconds of each host span named ``name`` in the window."""
        return [d / 1e6 for n, _, d in self.spans if n == name]

    def device_ops(self) -> List[list]:
        by_name: Dict[str, float] = defaultdict(float)
        for n, _, d in self.ops:
            by_name[n[:160]] += d / 1e6
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """Idle seconds of the device inside the window, summed by the
        innermost host span open at each gap's midpoint (``host`` where
        none is): the longest first."""
        gaps, prev = [], self.t0
        for a, b in self.busy_intervals:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        # sweep: span starts and ends against the gap midpoints (one host
        # thread's spans nest, so a stack holds the open ones)
        marks = []
        for i, (_, ts, dur) in enumerate(self.spans):
            marks.append((ts, 1, i))
            marks.append((ts + dur, 0, i))
        for j, (a, b) in enumerate(gaps):
            marks.append((0.5 * (a + b), 2, j))
        marks.sort(key=lambda m: (m[0], m[1]))
        stack: List[int] = []
        label = {}
        for _, what, i in marks:
            if what == 1:
                stack.append(i)
            elif what == 0:
                if i in stack:
                    stack.remove(i)
            else:
                label[i] = self.spans[stack[-1]][0] if stack else "host"
        by_label: Dict[str, float] = defaultdict(float)
        for j, (a, b) in enumerate(gaps):
            by_label[label[j]] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]]


class Tracer:
    """``with Tracer() as t:`` profiles the block, which must hold the
    window span; afterwards ``t.view`` is its ``TraceView``."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(PAD):
            torch.cuda._sleep(20_000)  # cycles
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(prefix="h100_bench_trace_", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.view = TraceView(events)
        return False


def percentile(values: List[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0..100) by linear interpolation between
    closest ranks, as numpy's default; None for no values."""
    if not values:
        return None
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


@contextlib.contextmanager
def nothing():
    """A context that does nothing (no tracer, no sampler)."""
    yield None
