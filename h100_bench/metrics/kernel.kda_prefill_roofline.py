"""K5's share of its roofline: the bound of every KDA prefill call in the
traced window (``lib/kda_bounds.py::k5_bound_s``: the larger of its bytes
read and written once over HBM bandwidth and the recurrence's operations
over the bf16 peak) over the device time of the kernel named
``kda_prefill_k5``, in %."""

PATTERN = "kda_prefill_k5"


def read(r):
    c = r.counters
    if r.view is None or "k5_bound_s" not in c:
        return None
    spent = r.view.op_seconds(PATTERN)
    if spent <= 0:
        return None
    return 100.0 * c["k5_bound_s"] / spent
