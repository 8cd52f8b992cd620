"""The median query latency of the traced window."""

from h100_bench.lib.trace import percentile


def read(r):
    p = percentile(r.latencies_s, 50)
    return None if p is None else 1e3 * p
