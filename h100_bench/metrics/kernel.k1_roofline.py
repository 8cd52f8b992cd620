"""K1's share of its roofline: the larger of the valid operations at the
bf16 peak and the operands read once at HBM bandwidth
(``lib/bounds.py::mrsw_bound``) over K1's device time by kernel name, in %."""

PATTERN = "mrsw_kernel"


def read(r):
    c = r.counters
    if r.view is None or "k1_bound_s_per_call" not in c:
        return None
    spent = r.view.op_seconds(PATTERN)
    if spent <= 0:
        return None
    calls = len(r.view.span_durations("score.scores"))
    return 100.0 * c["k1_bound_s_per_call"] * calls / spent
