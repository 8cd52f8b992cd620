"""The routed experts' share of their roofline: the bound of every MoE
call in the traced window (``lib/vlm_bounds.py``: each prefill call by its
operations, the cached steps' calls by the bytes of the experts they hit,
from the program's counter ``moe.experts_hit``) over the device time of
the grouped GEMM kernels, in %. None where the program counts no experts
hit or no grouped GEMM ran."""

from h100_bench.lib import spans, vlm_bounds

PATTERNS = ("GroupProblemShape", "grouped_gemm", "GroupedGemm")  # torch._grouped_mm's kernels


def read(r):
    c = r.counters
    if r.view is None or "step_calls" not in c:
        return None
    hits = spans.traced_counter("moe.experts_hit")
    spent = sum(s for n, s in kernel_seconds(r.view))
    if not hits or spent <= 0:
        return None
    bound = c["prefill_expert_bound_s"] + vlm_bounds.step_expert_bound_s(
        c["vlm_config"], c["step_batch"], c["step_calls"], hits)
    return 100.0 * bound / spent


def kernel_seconds(view):
    """(name, seconds) of the device operations that are grouped GEMMs."""
    by = {}
    for n, _, d in view.ops:
        if any(p in n for p in PATTERNS):
            by[n] = by.get(n, 0.0) + d / 1e6
    return sorted(by.items())
