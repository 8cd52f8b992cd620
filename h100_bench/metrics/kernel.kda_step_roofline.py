"""K6's share of its roofline: the bound of every KDA decode step in the
traced window (``lib/kda_bounds.py::k6_bound_s``: each row's state and
convolution tails read and written once, and one token's inputs and
output, over HBM bandwidth) over the device time of the kernel named
``kda_step_k6``, which also updates the tails, in %."""

PATTERN = "kda_step_k6"


def read(r):
    c = r.counters
    if r.view is None or "k6_bound_s" not in c:
        return None
    spent = r.view.op_seconds(PATTERN)
    if spent <= 0:
        return None
    return 100.0 * c["k6_bound_s"] / spent
