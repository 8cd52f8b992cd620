"""Readings of the program's own spans and counters in a traced window.

The port opens spans inside its layers (``aladin_torch/utils/profiling.py``:
``step.*``, ``decode.*``, ``mrsw.*``, ``search.*``); they are
``user_annotation`` events of the same profiler session as the device's
records, so ``TraceView.spans`` holds them beside the runners' spans on one
clock. A program without them (an older commit) has none: each reading here
is then None, and the metric is left out of the line.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def _union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(xs: Sequence[Interval], ys: Sequence[Interval]) -> float:
    """Length of the intersection of two unions of disjoint sorted intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_seconds(view, name: str) -> List[float]:
    """Each span named ``name`` in the window: its seconds less the part of
    its interval that the spans nested in it cover."""
    out = []
    for k, (n, ts, dur) in enumerate(view.spans):
        if n != name:
            continue
        end = ts + dur
        children = [(t, t + d) for j, (_, t, d) in enumerate(view.spans)
                    if j != k and t >= ts and t + d <= end]
        out.append((dur - sum(b - a for a, b in _union(children))) / 1e6)
    return out


def idle_seconds(view, prefix: str) -> float:
    """Seconds of the window in which the device ran nothing, inside a span
    whose name starts with ``prefix``."""
    gaps, prev = [], view.t0
    for a, b in view.busy_intervals:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if view.t1 > prev:
        gaps.append((prev, view.t1))
    inside = _union([(max(ts, view.t0), min(ts + dur, view.t1))
                     for n, ts, dur in view.spans if n.startswith(prefix)])
    return _overlap(gaps, inside) / 1e6


def median_ms(values: Sequence[float]) -> Optional[float]:
    """The median of seconds in ms; None for no values."""
    return 1e3 * statistics.median(values) if values else None


def traced_counter(name: str) -> Optional[int]:
    """The program's traced tally of the counter ``name`` (the profiler's
    session is the window's); None where the program has no counters."""
    try:
        from aladin_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    return counters(traced=True).get(name, 0)
