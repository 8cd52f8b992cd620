#!/usr/bin/env python3
"""What one span and one count of ``aladin_torch/utils/profiling.py`` cost
on the host, with no profiler recording and under a ``torch.profiler``
session (CPU activity, and CUDA activity where a card is present).

    python3 tools/span_cost.py

Each figure is the best of 5 timed loops of many calls, less the cost of
the empty loop, in microseconds a call: ``span_off_us`` (the flag check and
the shared no-op), ``record_function_off_us`` (an ungated
``record_function``, for comparison), ``count_off_us``, and ``span_on_us``
/ ``count_on_us`` while the profiler records. Prints one JSON line with the
device's name.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from aladin_torch.utils import profiling  # noqa: E402


def per_call_us(fn, n: int) -> float:
    fn(n // 10)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        fn(n)
        best = min(best, time.perf_counter() - t0)
    return 1e6 * best / n


def empty(n):
    for _ in range(n):
        pass


def spans(n):
    for _ in range(n):
        with profiling.span("cost.span"):
            pass


def ungated(n):
    for _ in range(n):
        with torch.profiler.record_function("cost.span"):
            pass


def counts(n):
    for _ in range(n):
        profiling.count("cost.count")


def main() -> None:
    loop = per_call_us(empty, 1_000_000)
    out = {"span_off_us": per_call_us(spans, 1_000_000) - loop,
           "record_function_off_us": per_call_us(ungated, 200_000) - loop,
           "count_off_us": per_call_us(counts, 1_000_000) - loop}
    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])):
        out["span_on_us"] = per_call_us(spans, 20_000) - loop
        out["count_on_us"] = per_call_us(counts, 200_000) - loop
    out["device"] = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
