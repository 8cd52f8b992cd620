"""The share of the MrSw operations handed to K1 that the scored pairs
need: the valid operations of a call (``lib/bounds.py::mrsw_valid_ops``)
times the program's ``mrsw.bucketed`` spans, over its traced counter
``mrsw.launched_ops`` (2 x D x N_im x R x N_cap x W of each bucket's
operands after normalising and stripping), in %."""

from h100_bench.lib import spans


def read(r):
    c = r.counters
    if r.view is None or "valid_ops_per_call" not in c:
        return None
    calls = len(r.view.span_durations("mrsw.bucketed"))
    launched = spans.traced_counter("mrsw.launched_ops")
    if not calls or not launched:
        return None
    return 100.0 * c["valid_ops_per_call"] * calls / launched
