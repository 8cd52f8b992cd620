"""The MrSw operations that the scored pairs need (valid regions x valid
words x D x 2, ``lib/bounds.py::mrsw_valid_ops``) over the time of the
whole calls, scoring and ranking, at the bf16 peak, in %."""

from h100_bench.lib.bounds import PEAK_OPS_PER_S


def read(r):
    c = r.counters
    if r.view is None or "valid_ops_per_call" not in c:
        return None
    spent = sum(r.view.span_durations("score.scores")) + sum(r.view.span_durations("score.ranks"))
    if spent <= 0:
        return None
    calls = len(r.view.span_durations("score.scores"))
    return 100.0 * c["valid_ops_per_call"] * calls / (spent * PEAK_OPS_PER_S["bf16"])
