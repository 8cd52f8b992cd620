"""K2's share of its roofline in the train step: the forward and backward
bounds at the step's two sequence lengths (``lib/bounds.py::
attention_bound``, per layer and pass) over K2's device time by kernel
name, in %."""

PATTERNS = ("attn_fwd_bf16", "attn_bwd_bf16")


def read(r):
    c = r.counters
    if r.view is None or "k2_bound_s_per_step" not in c:
        return None
    spent = sum(r.view.op_seconds(p) for p in PATTERNS)
    if spent <= 0:
        return None
    steps = r.units * c["steps_per_unit"]
    return 100.0 * c["k2_bound_s_per_step"] * steps / spent
