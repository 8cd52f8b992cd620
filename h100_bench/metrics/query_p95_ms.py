"""The 95th percentile of every query's latency in the window, from its
hand-off to its top-k on the host."""

from h100_bench.lib.trace import percentile


def read(r):
    p = percentile(r.latencies_s, 95)
    return None if p is None else 1e3 * p
